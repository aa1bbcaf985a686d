"""Carry a problem across from the JAX package: `problem_from_numpy`.

Duck-typed: the input is any object with the JAX `Problem`'s nested field
names (poses.q, lms.x, ..., pidx.sp_valid) whose leaves are array-likes —
for example the JAX problem after `np.asarray` on every leaf.  Nothing of
JAX is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .core import problem as pm

# Problem field -> node dataclass; the other Problem fields are leaves
_NODES = dict(poses=pm.PoseStates, lms=pm.LandmarkStates, rig=pm.Rig,
              proj=pm.ProjResiduals, unary=pm.UnaryResiduals,
              binary=pm.BinaryResiduals, imu=pm.ImuResiduals,
              marg=pm.MargPrior, pidx=pm.ProblemIndex)


def problem_from_numpy(tree, device="cuda") -> pm.Problem:
    """The port's Problem on `device` (CUDA by default; raises when CUDA is
    absent and `device` is not "cpu") from a tree of array-likes with the
    JAX Problem's field names.  dtypes are kept."""
    dev = resolve_device(device)

    def leaf(x):
        return torch.as_tensor(np.array(x, order="C"), device=dev)

    def node(cls, src):
        return cls(**{f.name: leaf(getattr(src, f.name))
                      for f in dataclasses.fields(cls)})

    return pm.Problem(**{
        f.name: (node(_NODES[f.name], getattr(tree, f.name))
                 if f.name in _NODES else leaf(getattr(tree, f.name)))
        for f in dataclasses.fields(pm.Problem)})
