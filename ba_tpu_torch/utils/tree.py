"""tree_map / tree_where over the problem dataclasses (the port's pytrees).

A leaf is a tensor (or None); a node is a dataclass instance whose fields
are leaves or nodes.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, *trees):
    """Apply `fn` leafwise over same-structured dataclass trees."""
    first = trees[0]
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first)})
    if first is None:
        return None
    return fn(*trees)


def tree_where(cond, a, b):
    """Leafwise `torch.where(cond, a, b)` with a scalar `cond` — the
    accept/reject select of a trial state.  Leaves shared by both trees
    (untouched by the update) are passed through as they are."""
    return tree_map(lambda x, y: x if x is y else torch.where(cond, x, y),
                    a, b)
