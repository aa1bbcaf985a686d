"""Rotations, poses and the poly3 camera in plain PyTorch.

Written from the definitions, not from the program: quaternions are
[w, x, y, z] (Hamilton product), a pose (q, t) maps vehicle to world, a pose
moves on the decoupled manifold R^3 x SO(3) as (q exp(dw), t + dt) with the
tangent [dt, dw], and poly3 projects a ray (x, y, z), z forward, to
(fx f(r) x / z + cx, fy f(r) y / z + cy), f(r) = 1 + k1 r^2 + k2 r^4 + k3 r^6
with r the radius of (x / z, y / z): BAL's radial model with k3 = 0, and the
radial part of EuRoC's radtan.  Every function is batched over leading axes
and differentiable by `torch.func`.
"""

from __future__ import annotations

import torch


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def quat_mul(a, b):
    aw, av = a[..., :1], a[..., 1:]
    bw, bv = b[..., :1], b[..., 1:]
    w = aw * bw - (av * bv).sum(-1, keepdim=True)
    v = aw * bv + bw * av + cross(av, bv)
    return torch.cat([w, v], -1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def rotate(q, x):
    """R(q) x = x + 2 w (u x x) + 2 u x (u x x), q = [w, u]: the rotation
    for a unit quaternion (the form Eigen uses; a quaternion rounded to a
    lower precision is not quite unit, and this form is the one stated)."""
    w, u = q[..., :1], q[..., 1:]
    c = 2.0 * cross(u, x)
    return x + w * c + cross(u, c)


def quat_normalize(q):
    return q / q.norm(dim=-1, keepdim=True)


def so3_exp(w):
    """Unit quaternion of the rotation vector w (series below 1e-4 rad)."""
    th2 = (w * w).sum(-1, keepdim=True)
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    s = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / th)
    c = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    return torch.cat([c, s * w], -1)


def so3_log(q):
    """Rotation vector of a unit quaternion, on the short geodesic."""
    q = torch.where(q[..., :1] < 0, -q, q)
    w, v = q[..., :1], q[..., 1:]
    n2 = (v * v).sum(-1, keepdim=True)
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    ws = torch.where(w.abs() < 1e-12, torch.ones_like(w), w)
    k = torch.where(small, 2.0 / ws - 2.0 * n2 / (3.0 * ws ** 3),
                    2.0 * torch.atan2(n, w) / n)
    return k * v


def retract(q, t, d):
    """The pose moved by the tangent d = [dt(3), dw(3)]."""
    return quat_mul(q, so3_exp(d[..., 3:6])), t + d[..., 0:3]


def to_sensor(q, t, tvs_q, tvs_t, x_w, w=None):
    """Sensor-frame coordinates of the world point x_w (homogeneous weight
    w, 1 when None) seen by the camera tvs on the pose (q, t)."""
    qs = quat_mul(q, tvs_q)
    ts = t + rotate(q, tvs_t)
    d = x_w - (ts if w is None else ts * w)
    return rotate(quat_conj(qs), d)


def from_sensor(q, t, tvs_q, tvs_t, ray, w):
    """World homogeneous point (xyz, weight w) of the sensor ray scaled by
    1 / w: R_ws ray + t_ws w."""
    qs = quat_mul(q, tvs_q)
    ts = t + rotate(q, tvs_t)
    return rotate(qs, ray) + ts * w


def project_poly3(params, p):
    """Pixel of the sensor-frame point p (z forward) through poly3 with
    params [fx, fy, cx, cy, k1, k2, k3]."""
    xn, yn = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
    r2 = xn * xn + yn * yn
    k1, k2, k3 = params[..., 4], params[..., 5], params[..., 6]
    f = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return torch.stack([params[..., 0] * f * xn + params[..., 2],
                        params[..., 1] * f * yn + params[..., 3]], -1)


def unproject_poly3(params, pix, iters=30):
    """Unit sensor ray of a pixel: the undistorted radius by Newton's method
    on r (1 + k1 r^2 + k2 r^4 + k3 r^6) = r_d, run to convergence."""
    xd = (pix[..., 0] - params[..., 2]) / params[..., 0]
    yd = (pix[..., 1] - params[..., 3]) / params[..., 1]
    rd = torch.sqrt(xd * xd + yd * yd)
    rd_safe = torch.where(rd < 1e-12, torch.ones_like(rd), rd)
    k1, k2, k3 = params[..., 4], params[..., 5], params[..., 6]
    r = rd_safe
    for _ in range(iters):
        r2 = r * r
        g = r * (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) - rd_safe
        dg = 1.0 + r2 * (3.0 * k1 + r2 * (5.0 * k2 + r2 * 7.0 * k3))
        r = r - g / dg
    s = torch.where(rd < 1e-12, torch.ones_like(rd), r / rd_safe)
    ray = torch.stack([xd * s, yd * s, torch.ones_like(xd)], -1)
    return ray / ray.norm(dim=-1, keepdim=True)


def matrix_to_quat(R):
    """Unit quaternion of rotation matrices (..., 3, 3), from the largest of
    the four pivots."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = torch.stack([
        torch.stack([1 + tr, m[..., 2, 1] - m[..., 1, 2],
                     m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1]], -1),
        torch.stack([m[..., 2, 1] - m[..., 1, 2], 1 + m[..., 0, 0]
                     - m[..., 1, 1] - m[..., 2, 2], m[..., 0, 1] + m[..., 1, 0],
                     m[..., 0, 2] + m[..., 2, 0]], -1),
        torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                     1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                     m[..., 1, 2] + m[..., 2, 1]], -1),
        torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1],
                     1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1)],
        -2)
    piv = torch.stack([1 + tr, 1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                       1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                       1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1)
    k = piv.argmax(-1)
    q = torch.gather(cands, -2, k[..., None, None].expand(
        *k.shape, 1, 4))[..., 0, :]
    q = quat_normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)
