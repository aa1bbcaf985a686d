"""Unary (pose prior) and binary (relative pose) residuals.

Port of `ba_tpu/core/residuals/prior.py`.  Residuals are 6-dim on the
decoupled SE3 manifold, whitened by a triangular factor of cov_inv:

  unary:  r = log_decoupled(T_wp, T_prior)
  binary: r = log_decoupled(T_w1 * T_12_meas, T_w2)

The Jacobians are written out (ba_tpu differentiates with `vmap(jacfwd)`,
which in eager PyTorch cost ~40-70 ms of host time a call on the card).
With the right retraction T exp(delta) and the rotation part
phi = log(q_e), q_e = q_a q_b^-1: a right perturbation of q_a by w moves
q_e to q_e exp(R_b w) and of q_b by w to q_e exp(-R_b w) (unit
quaternions), and log(exp(phi) exp(d)) = phi + Jr^-1(phi) d to first
order, Jr^-1(phi) = I + [phi]x / 2 + c [phi]x^2 with
c = 1 / theta^2 - cot(theta / 2) / (2 theta), theta = |phi|.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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
    T1 = lie.se3_retract((q1, t1), delta[..., :6])
    T2 = lie.se3_retract((q2, t2), delta[..., 6:])
    pred = lie.se3_compose(T1, (mq, mt))
    return lie.se3_log_decoupled(pred, T2)


def _skew(v):
    """[v]x, (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([z, -v[..., 2], v[..., 1],
                        v[..., 2], z, -v[..., 0],
                        -v[..., 1], v[..., 0], z], dim=-1).reshape(
                            *v.shape[:-1], 3, 3)


def _log_jac(qe, phi):
    """Jr^-1(phi) (..., 3, 3) of phi = so3_log(qe): on the short geodesic
    (w >= 0), theta = 2 atan2(|v|, w) and cot(theta / 2) = w / |v|; the
    Taylor branch 1/12 + theta^2/720 near 0."""
    qe = qe * torch.where(qe[..., 0:1] < 0, -1.0, 1.0)
    w = qe[..., 0]
    n = torch.sqrt(torch.sum(qe[..., 1:] * qe[..., 1:], dim=-1))
    theta = 2.0 * torch.atan2(n, w)
    small = theta < 1e-3
    th = torch.where(small, torch.ones_like(theta), theta)
    n_s = torch.where(small, torch.ones_like(n), n)
    c = torch.where(small, 1.0 / 12.0 + theta * theta / 720.0,
                    1.0 / (th * th) - w / (2.0 * th * n_s))
    K = _skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + 0.5 * K + c[..., None, None] * (K @ K)


def _rot_part(qa, qb):
    """(phi, Jr^-1(phi)) of phi = so3_log(q_a q_b^-1)."""
    qe = lie.quat_mul(qa, lie.quat_conj(qb))
    phi = lie.so3_log(qe)
    return phi, _log_jac(qe, phi)


def evaluate_unary(problem, config, with_jacobians=True) -> PriorEval:
    u = problem.unary
    poses = problem.poses
    args = (u.t.new_zeros((u.pose.shape[0], 6)), poses.q[u.pose],
            poses.t[u.pose], u.q, u.t)
    r = _unary_r(*args)
    J = r.new_zeros(r.shape + (6,))
    if with_jacobians:
        # d r_t / d t = I; d phi / d w = Jr^-1(phi) R_prior
        _, Ji = _rot_part(args[1], u.q)
        J[:, :3, :3] = torch.eye(3, dtype=r.dtype, device=r.device)
        J[:, 3:, 3:] = Ji @ lie.quat_to_matrix(u.q)
    return PriorEval(*_whiten(r, J, None, u.cov_inv, u.valid))


def evaluate_binary(problem, config, with_jacobians=True) -> PriorEval:
    b = problem.binary
    poses = problem.poses
    args = (b.t.new_zeros((b.pose1.shape[0], 12)),
            poses.q[b.pose1], poses.t[b.pose1],
            poses.q[b.pose2], poses.t[b.pose2], b.q, b.t)
    r = _binary_r(*args)
    J1 = r.new_zeros(r.shape + (6,))
    J2 = r.new_zeros(r.shape + (6,))
    if with_jacobians:
        # r_t = t1 + R1 t_meas - t2: d / d w1 = -R1 [t_meas]x; r_phi =
        # log(q1 q_meas q2^-1): d / d w1 = Jr^-1 R2 R_meas^T, d / d w2 =
        # -Jr^-1 R2
        q1, q2 = args[1], args[3]
        _, Ji = _rot_part(lie.quat_mul(q1, b.q), q2)
        eye = torch.eye(3, dtype=r.dtype, device=r.device)
        R2 = lie.quat_to_matrix(q2)
        J1[:, :3, :3] = eye
        J1[:, :3, 3:] = -lie.quat_to_matrix(q1) @ _skew(b.t)
        J1[:, 3:, 3:] = Ji @ R2 @ lie.quat_to_matrix(b.q).transpose(-1, -2)
        J2[:, :3, :3] = -eye
        J2[:, 3:, 3:] = -(Ji @ R2)
    return PriorEval(*_whiten(r, J1, J2, b.cov_inv, b.valid))
