"""Unary (pose prior) and binary (relative pose) residuals.

Port of `ba_tpu/core/residuals/prior.py`.  Residuals are 6-dim on the
decoupled SE3 manifold, whitened by a triangular factor of cov_inv:

  unary:  r = log_decoupled(T_wp, T_prior)
  binary: r = log_decoupled(T_w1 * T_12_meas, T_w2)
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from .. import lie
from ...utils.linalg import whiten_factor


class PriorEval(NamedTuple):
    r: torch.Tensor        # (N, 6) whitened
    j1: torch.Tensor       # (N, 6, 6) whitened, wrt pose (or pose1)
    j2: torch.Tensor       # (N, 6, 6) whitened, wrt pose2 (zeros for unary)
    err_sq: torch.Tensor   # (N,) squared mahalanobis error


def _whiten(r, J1, J2, cov_inv, valid):
    S = whiten_factor(cov_inv)
    rw = torch.einsum("nij,nj->ni", S, r)
    j1w = torch.einsum("nij,njk->nik", S, J1)
    j2w = torch.einsum("nij,njk->nik", S, J2) if J2 is not None else \
        torch.zeros_like(j1w)
    m = valid[:, None]
    rw = torch.where(m, rw, 0.0)
    j1w = torch.where(m[..., None], j1w, 0.0)
    j2w = torch.where(m[..., None], j2w, 0.0)
    err_sq = torch.einsum("ni,nij,nj->n", r, cov_inv, r)
    err_sq = torch.where(valid, err_sq, 0.0)
    return rw, j1w, j2w, err_sq


def _unary_r(delta, pq, pt, uq, ut):
    q, t = lie.se3_retract((pq, pt), delta)
    return lie.se3_log_decoupled((q, t), (uq, ut))


def _binary_r(delta, q1, t1, q2, t2, mq, mt):
    T1 = lie.se3_retract((q1, t1), delta[:6])
    T2 = lie.se3_retract((q2, t2), delta[6:])
    pred = lie.se3_compose(T1, (mq, mt))
    return lie.se3_log_decoupled(pred, T2)


def evaluate_unary(problem, config, with_jacobians=True) -> PriorEval:
    u = problem.unary
    poses = problem.poses
    args = (u.t.new_zeros((u.pose.shape[0], 6)), poses.q[u.pose],
            poses.t[u.pose], u.q, u.t)
    r = vmap(_unary_r)(*args)
    if with_jacobians:
        J = vmap(jacfwd(_unary_r))(*args)
    else:
        J = r.new_zeros(r.shape + (6,))
    return PriorEval(*_whiten(r, J, None, u.cov_inv, u.valid))


def evaluate_binary(problem, config, with_jacobians=True) -> PriorEval:
    b = problem.binary
    poses = problem.poses
    args = (b.t.new_zeros((b.pose1.shape[0], 12)),
            poses.q[b.pose1], poses.t[b.pose1],
            poses.q[b.pose2], poses.t[b.pose2], b.q, b.t)
    r = vmap(_binary_r)(*args)
    if with_jacobians:
        J = vmap(jacfwd(_binary_r))(*args)
        J1, J2 = J[..., :6], J[..., 6:]
    else:
        J1 = r.new_zeros(r.shape + (6,))
        J2 = J1
    return PriorEval(*_whiten(r, J1, J2, b.cov_inv, b.valid))
