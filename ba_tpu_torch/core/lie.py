"""Batched SO(3)/SE(3) math on quaternions, autodiff-safe everywhere.

Port of `ba_tpu/core/lie.py`.  The maps (exp/log/compose/act) are written
so that `torch.func.jacfwd` through them is exact: every near-identity
singularity has a Taylor branch guarded with the double-`where` idiom, so
both the primal and its derivatives stay NaN-free.

Conventions (as in the reference):
  * quaternions are `[w, x, y, z]`, batched over leading axes;
  * SE(3) is the decoupled product manifold R^3 x SO(3):
      - `se3_log_decoupled(a, b) = [a.t - b.t, so3_log(a.R @ b.R^T)]`;
      - retraction `se3_retract((q,t), [dt,dw]) = (q*exp(dw), t+dt)`;
  * tangent layout is `[translation(3), rotation(3)]`.

All functions keep the input dtype and device.
"""

from __future__ import annotations

import torch

# Threshold below which Taylor branches take over.
_SMALL = 1e-6


def _safe(x, small=_SMALL):
    """Replace near-zero values by 1 so the unused `where` branch stays finite."""
    return torch.where(x.abs() < small, torch.ones_like(x), x)


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions ([w, x, y, z])
# ---------------------------------------------------------------------------


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_mul(a, b):
    """Hamilton product a*b, batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def quat_rotate(q, v):
    """R(q) @ v via 2*(q_v x (q_v x v + w v)) + v (exact for unit q)."""
    w = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def quat_to_matrix(q):
    """Rotation matrix from unit quaternion, shape (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(*q.shape[:-1], 3, 3)


def matrix_to_quat(m):
    """Unit quaternion [w,x,y,z] from rotation matrix, batched, branch-free
    (all four Shepperd candidates, best-conditioned one selected)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    s0 = torch.sqrt(torch.clamp(tr + 1.0, min=1e-30)) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-30)) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-30)) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-30)) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = torch.where(use0, q0, torch.where(use1, q1,
                                          torch.where(use2, q2, q3)))
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3) exp / log
# ---------------------------------------------------------------------------


def so3_exp(w):
    """exp: R^3 tangent -> unit quaternion, Taylor branch near 0 (guard on
    theta^2 before the sqrt so derivatives of the unused branch stay
    finite)."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta_sq < _SMALL**2
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq),
                                   theta_sq))
    half = 0.5 * theta
    sinc_half = torch.where(small, 0.5 - theta_sq / 48.0,
                            torch.sin(half) / theta)
    cos_half = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([cos_half, sinc_half * w], dim=-1)


def so3_log(q):
    """log: unit quaternion -> R^3 tangent on the short geodesic, Taylor
    branch near identity."""
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    w = q[..., 0:1]
    v = q[..., 1:4]
    n_sq = torch.sum(v * v, dim=-1, keepdim=True)
    small = n_sq < _SMALL**2
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    w_safe = _safe(w, 1e-12)
    scale = torch.where(
        small,
        2.0 / w_safe - 2.0 * n_sq / (3.0 * w_safe**3),
        2.0 * torch.atan2(n, w) / n,
    )
    return scale * v


def so3_retract(q, dw):
    """Right retraction: q * exp(dw)."""
    return quat_mul(q, so3_exp(dw))


# ---------------------------------------------------------------------------
# Decoupled SE(3): tuples (q, t) — q: (...,4) wxyz, t: (...,3)
# ---------------------------------------------------------------------------


def se3_compose(a, b):
    """T_a * T_b."""
    qa, ta = a
    qb, tb = b
    return quat_mul(qa, qb), ta + quat_rotate(qa, tb)


def se3_inverse(a):
    q, t = a
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def se3_transform_homog(a, ph):
    """Apply SE3 to a homogeneous 4-vector [xyz, rho]: [R xyz + t rho, rho]
    (the inverse-depth landmark transfer)."""
    q, t = a
    xyz = quat_rotate(q, ph[..., :3]) + t * ph[..., 3:4]
    return torch.cat([xyz, ph[..., 3:4]], dim=-1)


def se3_log_decoupled(a, b):
    """[a.t - b.t, so3_log(q_a * q_b^-1)]."""
    qa, ta = a
    qb, tb = b
    return torch.cat([ta - tb, so3_log(quat_mul(qa, quat_conj(qb)))],
                     dim=-1)


def se3_retract(a, x):
    """(q*exp(x[3:6]), t + x[0:3]); the solver applies `-delta`."""
    q, t = a
    return so3_retract(q, x[..., 3:6]), t + x[..., 0:3]


# ---------------------------------------------------------------------------
# Gravity parameterization
# ---------------------------------------------------------------------------

GRAVITY = 9.8007


def gravity_vector(g2, magnitude=GRAVITY):
    """3-vector from direction angles [theta, phi]; (0, 0) -> (0, 0, -mag)."""
    th, ph = g2[..., 0], g2[..., 1]
    return magnitude * torch.stack(
        [-torch.sin(th), torch.cos(th) * torch.sin(ph),
         -torch.cos(th) * torch.cos(ph)], dim=-1)

