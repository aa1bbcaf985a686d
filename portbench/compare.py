"""The numbers that decide `correct`: a solve of the program against the
plain reference's solve of the same scene.

For every kept solve of the window:

  cost_gap    the widest relative gap between the program's cost after
              each iteration and the reference's;
  pose_gap    |t - t_ref| over every pose, relative to |t_ref - t_start|:
              where the program ended against how far the reference moved;
  rot_gap     the same of the rotations (the rotation vectors of
              q q_ref^-1 against q_ref q_start^-1);
  lm_gap      the same of the landmarks' optimized coordinates (points, or
              inverse distances);
  vel_gap, bias_gap   the same of velocities and biases (pose_dim 9, 15).

In a fleet of equal windows each state gap is taken window by window and
the worst window's is the number, so one faulty window is not diluted
among the others.

A number that is not finite reads as infinite.  The limits, one file per
cell (`limits/<workload>.json`), were set from the program's readings over
a dozen seeds and the control's (the reference in TF32, in the program's
place), as `PERF.md` records.
"""

from __future__ import annotations

import math

import torch

from .reference import geometry as geo


def _rel(a, b, base, windows=1):
    """The worst window's |a - b| / |base|; states are laid out window by
    window, each window with the same count."""
    num = (a - b).reshape(windows, -1).norm(dim=1)
    den = base.reshape(windows, -1).norm(dim=1)
    if not bool(torch.isfinite(num).all()):
        return math.inf
    rel = torch.where(den > 0, num / den.clamp(min=1e-300),
                      torch.where(num == 0, 0.0, math.inf))
    return float(rel.max())


def numbers(out: dict, ref: dict, start, lm_size: int, pose_dim: int,
            windows: int = 1) -> dict:
    """The numbers of one program output `out` (states and costs, float64
    on the reference's device) against the reference's result `ref` and
    the start state `start` (a `reference.ba.State`), for a scene of
    `windows` equal windows."""
    st = ref["state"]
    n = {}
    rc, pc = ref["costs"], out["costs"]
    k = min(pc.shape[0], rc.shape[0])
    gap = ((pc[:k] - rc[:k]).abs() / rc[:k].abs()).max()
    n["cost_gap"] = float(gap) if torch.isfinite(gap) else math.inf
    w = windows
    n["pose_gap"] = _rel(out["t"], st.t, st.t - start.t, w)
    rv = geo.so3_log(geo.quat_mul(out["q"], geo.quat_conj(st.q)))
    rv_ref = geo.so3_log(geo.quat_mul(st.q, geo.quat_conj(start.q)))
    n["rot_gap"] = _rel(rv, torch.zeros_like(rv), rv_ref, w)
    lm = out["lm"][:, :3] if lm_size == 3 else out["lm"][:, 3]
    n["lm_gap"] = _rel(lm, st.lm, st.lm - start.lm, w)
    if pose_dim >= 9:
        n["vel_gap"] = _rel(out["v"], st.v, st.v - start.v, w)
    if pose_dim >= 15:
        n["bias_gap"] = _rel(out["b"], st.b, st.b - start.b, w)
    return n
