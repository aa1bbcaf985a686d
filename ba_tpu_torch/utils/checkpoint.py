"""Checkpoint / resume of solver state (port of
`ba_tpu/utils/checkpoint.py`).

A `Problem` (or any tree of the port's dataclasses, `utils/tree.py`)
round-trips through a single `.npz` in the JAX package's layout: the
leaves in field order as `leaf_0`, `leaf_1`, ... (None fields hold no
leaf, as in a JAX pytree) and a `__treedef__` entry, the UTF-8 JSON
{"repr": the tree's structure, "extra": the caller's dict}.  The two
packages' `Problem`s have the same fields in the same order, so either
package loads the other's checkpoint of the same problem leaf for leaf.
`save` / `load` keep every leaf's dtype and shape, so a resumed solve
continues bit-identically.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


def _flatten(tree):
    """(leaves in field order, structure string)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        leaves, parts = [], []
        for f in dataclasses.fields(tree):
            sub, rep = _flatten(getattr(tree, f.name))
            leaves += sub
            parts.append(rep)
        return leaves, f"{type(tree).__name__}({', '.join(parts)})"
    if tree is None:
        return [], "None"
    return [tree], "*"


def _unflatten(like, leaves):
    """A tree shaped as `like` with the next leaves of the iterator
    `leaves`."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)})
    if like is None:
        return None
    return next(leaves)


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, tree, extra: dict | None = None) -> None:
    leaves, rep = _flatten(tree)
    arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        json.dumps({"repr": rep, "extra": extra or {}}).encode(),
        dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load(path: str, like):
    """Restore into the structure of `like` (structure/shapes must match),
    each leaf on the device of `like`'s leaf, in its saved dtype."""
    data = np.load(path)
    leaves_like, rep = _flatten(like)
    n = len(leaves_like)
    n_saved = sum(1 for k in data.files if k.startswith("leaf_"))
    saved_repr = json.loads(
        bytes(data["__treedef__"]).decode()).get("repr", "?")
    if n_saved != n:
        raise ValueError(
            f"checkpoint structure mismatch: {n_saved} saved leaves vs "
            f"{n} in the target structure.\n  saved treedef:  "
            f"{saved_repr}\n  target treedef: {rep}")
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    for i, (a, b) in enumerate(zip(leaves, leaves_like)):
        if a.shape != tuple(b.shape):
            raise ValueError(
                f"checkpoint shape mismatch at leaf {i}: {a.shape} vs "
                f"{tuple(b.shape)} (saved treedef: {saved_repr})")
    out = (torch.as_tensor(a, device=b.device if isinstance(b, torch.Tensor)
                           else None) for a, b in zip(leaves, leaves_like))
    return _unflatten(like, out)


def extra(path: str) -> dict:
    data = np.load(path)
    meta = json.loads(bytes(data["__treedef__"]).decode())
    return meta.get("extra", {})
