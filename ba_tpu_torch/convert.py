"""Carry a problem or a ring schedule across from the JAX package:
`problem_from_numpy`, `ring_schedule_from_numpy`.

Duck-typed: the input is any object with the JAX `Problem`'s (or
`RingSchedule`'s) field names (poses.q, lms.x, ..., pidx.sp_valid) whose
leaves are array-likes, for example the JAX object after `np.asarray` on
every leaf.  Nothing of JAX is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .core import problem as pm
from .solver.fixedlag import RingSchedule

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
    return pm.Problem(**{
        f.name: (_node(_NODES[f.name], getattr(tree, f.name), dev)
                 if f.name in _NODES else _leaf(getattr(tree, f.name), dev))
        for f in dataclasses.fields(pm.Problem)})


def _leaf(x, dev):
    return torch.as_tensor(np.array(x, order="C"), device=dev)


def _node(cls, src, dev):
    return cls(**{f.name: _leaf(getattr(src, f.name), dev)
                  for f in dataclasses.fields(cls)})


def ring_schedule_from_numpy(sched, device="cuda") -> RingSchedule:
    """The port's RingSchedule on `device` (CUDA by default; raises when
    CUDA is absent and `device` is not "cpu") from an object with the JAX
    RingSchedule's fields: W, L_w, n_slides, the stacked `inputs` (with
    `pidx` a ProblemIndex), `carry0` = (q, t, v, b, lm_x, MargPrior),
    `rig` and `g_vec`.  dtypes are kept."""
    dev = resolve_device(device)
    inputs = {k: (_node(pm.ProblemIndex, v, dev) if k == "pidx"
                  else _leaf(v, dev)) for k, v in sched.inputs.items()}
    *states, marg = sched.carry0
    carry0 = tuple(_leaf(x, dev) for x in states) + (
        _node(pm.MargPrior, marg, dev),)
    return RingSchedule(W=int(sched.W), L_w=int(sched.L_w),
                        n_slides=int(sched.n_slides), inputs=inputs,
                        carry0=carry0, rig=_node(pm.Rig, sched.rig, dev),
                        g_vec=_leaf(sched.g_vec, dev))
