"""Kernel 1 (csrc/reprojection.cu), with Jacobians: `chip_smoke.py`'s
`phase_timing` count.  Bytes: the projection rows' z, ids and mask, the
poses, landmarks and rig it reads (with per-pose intrinsics, those too),
and every output; operations: 1,055 a row (the transfer chain, the
projection and the 13 Jacobian columns, counted from the source)."""

from __future__ import annotations

from . import nbytes

WRAPPER = ("ba_tpu_torch.kernels.reprojection", "reprojection")
K1_FLOPS_PER_ROW = 1055


def counted(args, kwargs) -> bool:
    """Only the calls with Jacobians (the build's) are this count's."""
    return bool(args[1])


def count(args, kwargs, out):
    problem = args[0]
    per_pose = kwargs.get("per_pose", args[6] if len(args) > 6 else False)
    pr, poses, lms, rig = problem.proj, problem.poses, problem.lms, problem.rig
    b = nbytes(pr.z, pr.pose, pr.lm, pr.cam, pr.valid, poses.q, poses.t,
               lms.x, lms.ref_pose, lms.ref_cam, rig.params, rig.model,
               rig.tvs_q, rig.tvs_t, *out)
    if per_pose:
        b += nbytes(poses.cam_params)
    rows = int(pr.valid.sum())
    return dict(bytes=b, flops=K1_FLOPS_PER_ROW * rows)


def match(name: str) -> bool:
    return "reprojection_kernel" in name and "true" in name
