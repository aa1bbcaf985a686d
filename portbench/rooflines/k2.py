"""K2 (a) (csrc/imu_preint.cu, `imu_full`: preintegration with Jacobians,
covariance and whitening): `chip_smoke.py`'s `phase_timing_imu` count.
Bytes: the poses and IMU tables it reads, every output; operations by the
chain rule, not the kernel's forward mode: 11,000 a RK4 step (primal, the
step Jacobian, the products and the covariance) and 7,800 a span (the
residual map, J1, J2, C9), plus the whitening."""

from __future__ import annotations

from . import nbytes

WRAPPER = ("ba_tpu_torch.kernels.imu_preint", "imu_full")
K2A_FLOPS_PER_STEP, K2A_FLOPS_PER_SPAN = 11000, 7800
K2_WHITEN_FLOPS = 360


def k2_flops(Ni, steps, R, D):
    whiten = K2_WHITEN_FLOPS + 2 * R * R + 4 * R * R * D
    return K2A_FLOPS_PER_STEP * steps + (K2A_FLOPS_PER_SPAN + whiten) * Ni


def count(args, kwargs, out):
    problem, config = args[0], args[1]
    im, poses = problem.imu, problem.poses
    Ni = im.time.shape[0]
    steps = int(((im.time[:, 1:] - im.time[:, :-1]) > 0).sum())
    ins = nbytes(poses.q, poses.t, poses.v, poses.b, im.pose1, im.pose2,
                 im.w, im.a, im.time, problem.g_vec, im.weight, im.valid,
                 im.cond, im.c9_set)
    D = config.pose_dim
    R = 15 if D >= 15 else 9
    return dict(bytes=ins + nbytes(*out), flops=k2_flops(Ni, steps, R, D))


def match(name: str) -> bool:
    return "imu_full_kernel" in name
