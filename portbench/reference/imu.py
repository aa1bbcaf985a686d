"""IMU spans: preintegration, covariance and whitened residuals.

Written from the definitions: the state (t, q, v) of pose 1 is integrated
over the span's samples by RK4, the measurements taken linearly between
samples (the midpoint stages at their mean), the biases added to the
measurements, gravity added in the world, the quaternion normalized after
each step (a step of no time leaves the state); the covariance C10 of
(t, q, v) propagates as
C <- A C A^T + B diag(gyro^2, accel^2) B^T / dt with A, B the step's
Jacobians in the state and the biases.  The residual against pose 2 is

  r = [ t_hat - t2,  log(q_hat q2^-1),  v_hat - v2,  b1 - b2 ]

whitened by chol(C9 + eps I)^-1, C9 = Jy C10 Jy^T its covariance, and the
bias rows by the random walk over the span's length.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch.func import jvp, vmap

from . import geometry as geo


@dataclass(frozen=True)
class ImuNoise:
    gyro_sigma: float
    accel_sigma: float
    gyro_bias_sigma: float
    accel_bias_sigma: float
    eps: float                      # the covariance floor of the precision

    @staticmethod
    def from_config(s: dict) -> "ImuNoise":
        imu = s["imu"]
        eps = 1e-8 if s.get("dtype", "float32") == "float32" else 1e-12
        return ImuNoise(imu["gyro_sigma"], imu["accel_sigma"],
                        imu["gyro_bias_sigma"], imu["accel_bias_sigma"], eps)


class ImuEval(NamedTuple):
    r: torch.Tensor                 # (Ni, R) whitened
    j1: Optional[torch.Tensor]      # (Ni, R, D) whitened
    j2: Optional[torch.Tensor]
    cov: torch.Tensor               # (Ni, 9, 9) C9 the whitening used


def jacobian(f, x):
    """J (N, m, n) of a function f: (N, n) -> (N, m) that is batched over
    its rows: forward mode along each of the n tangent axes, every row at
    once."""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :].expand(
        n, x.shape[0], n)
    return vmap(lambda u: jvp(f, (x,), (u,))[1], out_dims=2)(basis)


def _deriv(q, v, w, a, g):
    wq = torch.cat([torch.zeros_like(w[..., :1]), w], -1)
    return v, 0.5 * geo.quat_mul(q, wq), geo.rotate(q, a) + g


def _rk4(y, w0, a0, w1, a1, dt, bg, ba, g):
    """One step of the flat states y = [t(3), q(4), v(3)] (N, 10); dt
    (N, 1)."""
    t, q, v = y[..., 0:3], y[..., 3:7], y[..., 7:10]
    wm, am = 0.5 * (w0 + w1), 0.5 * (a0 + a1)
    k1 = _deriv(q, v, w0 + bg, a0 + ba, g)
    k2 = _deriv(q + 0.5 * dt * k1[1], v + 0.5 * dt * k1[2], wm + bg,
                am + ba, g)
    k3 = _deriv(q + 0.5 * dt * k2[1], v + 0.5 * dt * k2[2], wm + bg,
                am + ba, g)
    k4 = _deriv(q + dt * k3[1], v + dt * k3[2], w1 + bg, a1 + ba, g)
    out = [y_ + dt / 6.0 * (c1 + 2 * c2 + 2 * c3 + c4)
           for y_, c1, c2, c3, c4 in zip((t, q, v), k1, k2, k3, k4)]
    return torch.cat([out[0], geo.quat_normalize(out[1]), out[2]], -1)


def _r9(y, q2, t2, v2):
    """The pose and velocity residual of integrated states y against
    pose 2."""
    yq = geo.quat_normalize(y[..., 3:7])
    return torch.cat([y[..., 0:3] - t2,
                      geo.so3_log(geo.quat_mul(yq, geo.quat_conj(q2))),
                      y[..., 7:10] - v2], -1)


def _step(sc, k, y, bias):
    dt = (sc.imu_time[:, k + 1] - sc.imu_time[:, k])[:, None]
    yn = _rk4(y, sc.imu_w[:, k], sc.imu_a[:, k], sc.imu_w[:, k + 1],
              sc.imu_a[:, k + 1], dt, bias[:, :3], bias[:, 3:], sc.gravity)
    return torch.where(dt > 0, yn, y), dt


def evaluate(sc, st, noise: ImuNoise, D: int, jac: bool,
             cov: Optional[torch.Tensor] = None) -> ImuEval:
    """Whitened residuals (and Jacobians wrt the two poses' D dims) of every
    span; `cov` reuses a build's C9 (the trial costs).  The Jacobians chain
    each step's forward-mode Jacobian [A | B] in the state and the biases:
    Phi = A_M..A_1, Bsum = sum A_M..A_k+1 B_k, J1 = Jy [Phi Jy0 | Bsum]."""
    i1, i2 = sc.imu_pose1, sc.imu_pose2
    Ni, M = sc.imu_time.shape
    q1, t1, v1, b1 = st.q[i1], st.t[i1], st.v[i1], st.b[i1]
    q2, t2, v2, b2 = st.q[i2], st.t[i2], st.v[i2], st.b[i2]
    dtype, dev = st.t.dtype, st.t.device
    y = torch.cat([t1, q1, v1], -1)
    need = cov is None or jac
    if need:
        C = y.new_zeros((Ni, 10, 10))
        Phi = torch.eye(10, dtype=dtype, device=dev).expand(Ni, 10, 10)
        Bs = y.new_zeros((Ni, 10, 6))
        rq = torch.cat([y.new_full((3,), noise.gyro_sigma ** 2),
                        y.new_full((3,), noise.accel_sigma ** 2)])
    for k in range(M - 1):
        if need:
            z = torch.cat([y, y.new_zeros((Ni, 6))], -1)
            J = jacobian(lambda z: _step(sc, k, z[:, :10], b1 + z[:, 10:])[0],
                         z)
            yn, dt = _step(sc, k, y, b1)
            A, B = J[..., :10], J[..., 10:]
            Q = (B * rq / torch.clamp(dt, min=1e-12)[..., None]) @ B.mT
            C = A @ C @ A.mT + torch.where(dt[..., None] > 0, Q, 0.0)
            Phi = A @ Phi
            Bs = A @ Bs + B
            y = yn
        else:
            y, _ = _step(sc, k, y, b1)
    r = torch.cat([_r9(y, q2, t2, v2), b1 - b2], -1)
    if need:
        Jy = jacobian(lambda yy: _r9(yy, q2, t2, v2), y)
    if cov is None:
        cov = Jy @ C @ Jy.mT
    eye9 = torch.eye(9, dtype=cov.dtype, device=cov.device)
    L9 = torch.linalg.cholesky(cov + noise.eps * eye9)
    S9 = torch.linalg.solve_triangular(L9, eye9.expand_as(L9), upper=False)
    span = sc.imu_time.amax(-1) - sc.imu_time[:, 0]
    rb = torch.cat([st.t.new_full((3,), noise.gyro_bias_sigma ** 2),
                    st.t.new_full((3,), noise.accel_bias_sigma ** 2)])
    sb = 1.0 / torch.sqrt(rb[None] * torch.clamp(span, min=1e-12)[:, None])
    S = torch.zeros((Ni, 15, 15), dtype=cov.dtype, device=cov.device)
    S[:, :9, :9] = S9
    S[:, 9:, 9:] = torch.diag_embed(sb)
    S = S[:, :D, :D] if D < 15 else S
    R = S.shape[1]
    rw = (S @ r[:, :R, None])[..., 0]
    if not jac:
        return ImuEval(rw, None, None, cov)

    def y0(xi):
        q, t = geo.retract(q1, t1, xi[:, 0:6])
        return torch.cat([t, q, v1 + xi[:, 6:9]], -1)

    def r2(xi):
        q, t = geo.retract(q2, t2, xi[:, 0:6])
        return _r9(y, q, t, v2 + xi[:, 6:9])

    z9 = y.new_zeros((Ni, 9))
    J1 = torch.zeros((Ni, 15, 15), dtype=dtype, device=dev)
    J2 = torch.zeros((Ni, 15, 15), dtype=dtype, device=dev)
    J1[:, :9, :9] = Jy @ Phi @ jacobian(y0, z9)
    J1[:, :9, 9:] = Jy @ Bs
    J2[:, :9, :9] = jacobian(r2, z9)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    J1[:, 9:, 9:] = eye6
    J2[:, 9:, 9:] = -eye6
    return ImuEval(rw, S @ J1[:, :R, :D], S @ J2[:, :R, :D], cov)
