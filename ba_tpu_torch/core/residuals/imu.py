"""IMU preintegration residuals: RK4 integration + covariance, batched.

Port of `ba_tpu/core/residuals/imu.py`.  Each residual owns a padded span
of M measurements (padded steps have dt == 0 and pass the state through).
`integrate_full` is

  1. the RK4 state pass, a Python loop over the M-1 steps batched over
     spans;
  2. per-step A = d(step)/d(state), B = d(step)/d(bias) by
     `vmap(jacfwd)` of one RK4 step over all (span, step) pairs at once;
  3. the associative products Phi = A_M..A_1, Bsum and the Euler
     covariance C <- A C A^T + Q by a reshape-paired tree reduce, with
     identity padding for odd lengths.

Residual, res_dim 9 (pose_dim 9) or 15:
  r = [ log_decoupled(y_hat.t_wp, T_w2);  y_hat.v - v2;  b1 - b2 ]

On the card `evaluate` goes through kernel K2 (kernels/csrc/imu_preint.cu,
one launch with or without Jacobians); `full_plain` and `residual_plain`
are its plain versions, which the CPU runs.  The whitening stays plain.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from .. import lie
from ...utils.linalg import whiten_factor


class ImuEval(NamedTuple):
    r: torch.Tensor        # (Ni, R) whitened residuals
    j1: torch.Tensor       # (Ni, R, D) whitened, wrt pose1 tangent
    j2: torch.Tensor       # (Ni, R, D) whitened, wrt pose2 tangent
    err_sq: torch.Tensor   # (Ni,) squared mahalanobis error
    y_t: torch.Tensor      # (Ni, 3) integrated position (diagnostics)
    y_v: torch.Tensor      # (Ni, 3) integrated velocity
    c9: torch.Tensor       # (Ni, 9, 9) integrated residual covariance


def _quat_deriv(q, w_body):
    """q_dot = 0.5 * q x [0, w]."""
    wq = torch.cat([torch.zeros_like(w_body[..., :1]), w_body], dim=-1)
    return 0.5 * lie.quat_mul(q, wq)


def _state_deriv(y, w_meas, a_meas, bg, ba, g):
    """y = (t, q, v); biases correct the measurements additively."""
    t, q, v = y
    return (v, _quat_deriv(q, w_meas + bg),
            lie.quat_rotate(q, a_meas + ba) + g)


def _rk4_step(y, m0, m1, dt, bg, ba, g):
    """One RK4 step with measurement lerp at the midpoint (one span)."""
    w0, a0 = m0
    w1, a1 = m1
    wh, ah = 0.5 * (w0 + w1), 0.5 * (a0 + a1)

    def add(y, k, s):
        return (y[0] + s * k[0], y[1] + s * k[1], y[2] + s * k[2])

    k1 = _state_deriv(y, w0, a0, bg, ba, g)
    k2 = _state_deriv(add(y, k1, 0.5 * dt), wh, ah, bg, ba, g)
    k3 = _state_deriv(add(y, k2, 0.5 * dt), wh, ah, bg, ba, g)
    k4 = _state_deriv(add(y, k3, dt), w1, a1, bg, ba, g)
    t = y[0] + dt / 6.0 * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
    q = y[1] + dt / 6.0 * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
    v = y[2] + dt / 6.0 * (k1[2] + 2 * k2[2] + 2 * k3[2] + k4[2])
    return (t, lie.quat_normalize(q), v)


def _unflat(y10):
    return (y10[..., 0:3], y10[..., 3:7], y10[..., 7:10])


def _step10(y10, m0w, m0a, m1w, m1a, dt, bg, ba, g):
    """One RK4 step on the flat 10-state of one span."""
    return torch.cat(_rk4_step(_unflat(y10), (m0w, m0a), (m1w, m1a), dt,
                               bg, ba, g))


def _step_z(z, m0w, m0a, m1w, m1a, dt, bg, ba, g):
    """`_step10` as a function of z = [state(10), d_bg(3), d_ba(3)]."""
    return _step10(z[:10], m0w, m0a, m1w, m1a, dt, z[10:13] + bg,
                   z[13:16] + ba, g)


_STEP_DIMS = (0, 0, 0, 0, 0, 0, 0, 0, None)


def _state_pass(q1, t1, v1, b, w, a, times, g):
    """Final flat state (n, 10) and the pre-step states (n, M-1, 10)."""
    bg, ba = b[:, :3], b[:, 3:]
    y = torch.cat([t1, q1, v1], dim=-1)
    dts = times[:, 1:] - times[:, :-1]
    step = vmap(_step10, in_dims=_STEP_DIMS)
    y_pre = []
    for k in range(w.shape[1] - 1):
        y_pre.append(y)
        yn = step(y, w[:, k], a[:, k], w[:, k + 1], a[:, k + 1], dts[:, k],
                  bg, ba, g)
        y = torch.where((dts[:, k] > 0)[:, None], yn, y)
    if y_pre:
        return y, torch.stack(y_pre, dim=1)
    return y, y.new_zeros((y.shape[0], 0, 10))


def integrate_span(q1, t1, v1, b, w, a, times, g):
    """Integrate padded measurement spans (batched over the leading axis);
    returns the final (t, q, v)."""
    y, _ = _state_pass(q1, t1, v1, b, w, a, times, g)
    return _unflat(y)


def integrate_full(q1, t1, v1, b, w, a, times, g, r_imu):
    """(y, C10, Phi = dy/dy0, Bsum = dy/db) per span, batched."""
    n, M = w.shape[:2]
    dtype, device = t1.dtype, t1.device
    y_final, y_pre = _state_pass(q1, t1, v1, b, w, a, times, g)
    S = M - 1
    eye10 = torch.eye(10, dtype=dtype, device=device)

    # per-step A/B/Q over all (span, step) pairs at once
    dts = (times[:, 1:] - times[:, :-1]).reshape(-1)

    def rows(x):
        return x.reshape((n * S,) + x.shape[2:])

    bg = b[:, None, :3].expand(n, S, 3)
    ba = b[:, None, 3:].expand(n, S, 3)
    z = torch.cat([rows(y_pre), y_pre.new_zeros((n * S, 6))], dim=-1)
    J = vmap(jacfwd(_step_z), in_dims=_STEP_DIMS)(
        z, rows(w[:, :-1]), rows(a[:, :-1]), rows(w[:, 1:]),
        rows(a[:, 1:]), dts, rows(bg), rows(ba), g)
    A, B = J[..., :10], J[..., 10:]
    dt_safe = torch.clamp(dts, min=1e-12)
    Q = (B * r_imu / dt_safe[:, None, None]) @ B.transpose(-1, -2)
    on = (dts > 0)[:, None, None]
    A = torch.where(on, A, eye10)
    B = torch.where(on, B, 0.0)
    Q = torch.where(on, Q, 0.0)
    elems = [A.reshape(n, S, 10, 10), B.reshape(n, S, 10, 6),
             Q.reshape(n, S, 10, 10)]

    # pairwise tree reduce (later after earlier); odd lengths padded with
    # the identity element
    ident = (eye10, torch.zeros((10, 6), dtype=dtype, device=device),
             torch.zeros((10, 10), dtype=dtype, device=device))
    m = S
    if m == 0:
        elems = [e.expand(n, 1, *e.shape).clone() for e in ident]
        m = 1
    while m > 1:
        if m % 2:
            elems = [torch.cat([e, i.expand(n, 1, *i.shape)], dim=1)
                     for e, i in zip(elems, ident)]
            m += 1
        pairs = [e.reshape((n, m // 2, 2) + e.shape[2:]) for e in elems]
        A1, B1, Q1 = (p[:, :, 0] for p in pairs)
        A2, B2, Q2 = (p[:, :, 1] for p in pairs)
        elems = [A2 @ A1, A2 @ B1 + B2,
                 A2 @ Q1 @ A2.transpose(-1, -2) + Q2]
        m //= 2
    Phi, Bsum, C = (e[:, 0] for e in elems)
    return y_final, C, Phi, Bsum


def _dy0_dtangent(q1):
    """J_y0 (n, 10, 9): d(t1, q1_coords, v1) / d[dt(3), dw(3), dv(3)];
    rotation block 0.5 * q1 x [0, e_c]."""
    n = q1.shape[0]
    w, x, y, z = q1[:, 0], q1[:, 1], q1[:, 2], q1[:, 3]
    qcols = 0.5 * torch.stack([
        torch.stack([-x, -y, -z], dim=-1),
        torch.stack([w, -z, y], dim=-1),
        torch.stack([z, w, -x], dim=-1),
        torch.stack([-y, x, w], dim=-1)], dim=-2)            # (n, 4, 3)
    eye3 = torch.eye(3, dtype=q1.dtype, device=q1.device).expand(n, 3, 3)
    z3 = q1.new_zeros((n, 3, 3))
    z43 = q1.new_zeros((n, 4, 3))
    return torch.cat([
        torch.cat([eye3, z3, z3], dim=-1),
        torch.cat([z43, qcols, z43], dim=-1),
        torch.cat([z3, z3, eye3], dim=-1)], dim=-2)


def _res_map(y10, d2, q2, t2, v2):
    """Pose+velocity residual of the integrated state against pose2
    retracted by d2 (one span)."""
    yt, yq, yv = _unflat(y10)
    Q2, T2 = lie.se3_retract((q2, t2), d2[:6])
    rp = lie.se3_log_decoupled((lie.quat_normalize(yq), yt), (Q2, T2))
    return torch.cat([rp, yv - (v2 + d2[6:9])])


def _r_imu(config, dtype, device):
    # filled on the device: a host-built tensor would be a blocking copy
    kw = dict(dtype=dtype, device=device)
    return torch.cat([torch.full((3,), config.gyro_sigma**2, **kw),
                      torch.full((3,), config.accel_sigma**2, **kw)])


def full_plain(problem, config):
    """The plain version of kernel K2 (a): (r (Ni, R), j1, j2 (Ni, R, D),
    C9 (Ni, 9, 9), y_t, y_v) of every span, unwhitened; R = 15 with the
    bias rows, y_t / y_v are pose 1's t and v (ba_tpu's `evaluate`)."""
    im = problem.imu
    poses = problem.poses
    dtype, device = poses.t.dtype, poses.t.device
    D = config.pose_dim
    q1, t1 = poses.q[im.pose1], poses.t[im.pose1]
    v1, b1 = poses.v[im.pose1], poses.b[im.pose1]
    q2, t2 = poses.q[im.pose2], poses.t[im.pose2]
    v2, b2 = poses.v[im.pose2], poses.b[im.pose2]
    y10, C10, Phi, Bsum = integrate_full(q1, t1, v1, b1, im.w, im.a,
                                         im.time, problem.g_vec,
                                         _r_imu(config, dtype, device))
    Ni = im.pose1.shape[0]
    d2z = t1.new_zeros((Ni, 9))
    r9 = vmap(_res_map)(y10, d2z, q2, t2, v2)
    Jy = vmap(jacfwd(_res_map, argnums=0))(y10, d2z, q2, t2, v2)   # (9, 10)
    J2s = vmap(jacfwd(_res_map, argnums=1))(y10, d2z, q2, t2, v2)  # (9, 9)
    J1s = Jy @ (Phi @ _dy0_dtangent(q1))
    J1b = Jy @ Bsum
    C9 = Jy @ C10 @ Jy.transpose(-1, -2)
    if config.bias_in_state:
        r = torch.cat([r9, b1 - b2], dim=-1)
        eye6 = torch.eye(6, dtype=dtype, device=device).expand(Ni, 6, 6)
        z69 = t1.new_zeros((Ni, 6, 9))
        z96 = t1.new_zeros((Ni, 9, 6))
        j1 = torch.cat([torch.cat([J1s, J1b], dim=-1),
                        torch.cat([z69, eye6], dim=-1)], dim=1)
        j2 = torch.cat([torch.cat([J2s, z96], dim=-1),
                        torch.cat([z69, -eye6], dim=-1)], dim=1)
    else:
        r = r9
        j1 = J1s[:, :, :D]
        j2 = J2s[:, :, :D]
    return r, j1, j2, C9, t1, v1


def residual_plain(problem, config):
    """The plain version of kernel K2 (b): (r (Ni, R), y_t, y_v), the
    residual of the integrated state and its t and v."""
    im = problem.imu
    poses = problem.poses
    q1, t1 = poses.q[im.pose1], poses.t[im.pose1]
    v1, b1 = poses.v[im.pose1], poses.b[im.pose1]
    q2, t2 = poses.q[im.pose2], poses.t[im.pose2]
    v2, b2 = poses.v[im.pose2], poses.b[im.pose2]
    yt, yq, yv = integrate_span(q1, t1, v1, b1, im.w, im.a, im.time,
                                problem.g_vec)
    parts = [lie.se3_log_decoupled((yq, yt), (q2, t2)), yv - v2]
    if config.bias_in_state:
        parts.append(b1 - b2)
    return torch.cat(parts, dim=-1), yt, yv


def _full(problem, config):
    """Kernel K2 (a) for a problem on the card, its plain version on the
    CPU."""
    if problem.imu.w.is_cuda:
        from ...kernels import imu_preint

        return imu_preint.imu_full(problem, config.pose_dim,
                                   config.gyro_sigma**2,
                                   config.accel_sigma**2)
    return full_plain(problem, config)


def _residual(problem, config):
    """Kernel K2 (b) for a problem on the card, its plain version on the
    CPU."""
    if problem.imu.w.is_cuda:
        from ...kernels import imu_preint

        return imu_preint.imu_residual(problem, config.pose_dim)
    return residual_plain(problem, config)


def evaluate(problem, config, with_jacobians: bool = True,
             c9=None) -> ImuEval:
    """Residuals + Jacobians + information weighting for every IMU span:
    kernel K2 on the card (one launch of (a) with Jacobians, one of (b)
    without), its plain version on the CPU.  `c9` optionally supplies the
    (Ni, 9, 9) residual covariance from a previous build, so cost-only
    evaluation (trial costs) skips the covariance propagation; without it
    a cost-only evaluation takes (a)'s C9 (the Jacobian of `_c9`'s map
    equals (a)'s Jy)."""
    im = problem.imu
    dtype = problem.poses.t.dtype
    if not with_jacobians:
        r, yt, yv = _residual(problem, config)
        if c9 is None:
            c9 = _full(problem, config)[3]
        S = _whiten_from_c9(config, c9, im, dtype)
        return _whiten_pack(problem, config, r, None, None, S,
                            with_jacobians=False, y_t=yt, y_v=yv, c9=c9)

    r, j1, j2, C9, yt, yv = _full(problem, config)
    if config.calculate_inertial_covariance_once:
        C9 = torch.where(problem.imu.c9_set, problem.imu.c9, C9)
    S = _whiten_from_c9(config, C9, im, dtype)
    return _whiten_pack(problem, config, r, j1, j2, S,
                        with_jacobians=True, y_t=yt, y_v=yv, c9=C9)


def _whiten_from_c9(config, C9, im, dtype):
    """Whitening factor S (S^T S = weight * cov_inv) from the integrated
    covariance: S9 = chol(C9)^-1 by the closed-form blocked factor."""
    C9 = C9.detach()
    Ni = C9.shape[0]
    eps9 = 1e-12 if dtype == torch.float64 else 1e-8
    C9 = C9 + eps9 * torch.eye(9, dtype=dtype, device=C9.device)
    if config.imu_rotation_only:
        # whiten rows 3:6 by the rotation marginal factor, zero the rest
        S3 = whiten_factor(C9[:, 3:6, 3:6], from_cov=True)
        S9 = torch.nn.functional.pad(S3, (3, 3, 3, 3))
    else:
        S9 = whiten_factor(C9, from_cov=True)
    if config.bias_in_state:
        dt_total = torch.amax(im.time, dim=-1) - im.time[:, 0]
        kw = dict(dtype=dtype, device=C9.device)
        r_b = torch.cat([torch.full((3,), config.gyro_bias_sigma**2, **kw),
                         torch.full((3,), config.accel_bias_sigma**2, **kw)])
        cb = r_b[None, :] * torch.clamp(dt_total, min=1e-12)[:, None]
        S = torch.zeros((Ni, 15, 15), dtype=dtype, device=C9.device)
        S[:, :9, :9] = S9
        S[:, 9:, 9:] = torch.diag_embed(1.0 / torch.sqrt(cb))
    else:
        S = S9
    # persistent robust weight (cov_inv *= w -> factor *= sqrt(w));
    # conditioning edges exempt
    wgt = torch.where(im.cond, torch.ones_like(im.weight), im.weight)
    return S * torch.sqrt(wgt)[:, None, None]


def _whiten_pack(problem, config, r, j1, j2, S, with_jacobians, y_t, y_v,
                 c9):
    im = problem.imu
    dtype = r.dtype
    D = config.pose_dim
    res_dim = r.shape[-1]
    Ni = r.shape[0]
    valid = im.valid
    rw = torch.einsum("nij,nj->ni", S, r)
    rw = torch.where(valid[:, None], rw, 0.0)
    if config.imu_rotation_only:
        ar = torch.arange(res_dim, device=r.device)
        keep = ((ar >= 3) & (ar < 6)).to(dtype)
        rw = rw * keep[None, :]
    err_sq = torch.sum(rw * rw, dim=-1)
    if not with_jacobians:
        zj = r.new_zeros((Ni, res_dim, D))
        return ImuEval(rw, zj, zj, err_sq, y_t, y_v, c9)
    j1 = torch.where(valid[:, None, None], j1, 0.0)
    j2 = torch.where(valid[:, None, None], j2, 0.0)
    j1w = torch.einsum("nij,njk->nik", S, j1)
    j2w = torch.einsum("nij,njk->nik", S, j2)
    if config.imu_rotation_only:
        j1w = j1w * keep[None, :, None]
        j2w = j2w * keep[None, :, None]
    return ImuEval(rw, j1w, j2w, err_sq, y_t, y_v, c9)
