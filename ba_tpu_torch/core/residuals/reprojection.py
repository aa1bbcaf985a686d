"""Reprojection residuals + Jacobians.

Port of `ba_tpu/core/residuals/reprojection.py`.  The residual is written
once as a function of the tangent perturbation around the current states,
and the plain version takes its exact manifold Jacobians with
`torch.func.vmap(jacfwd(...))` at delta = 0.  On a CUDA problem `evaluate`
goes through the hand-written kernel (kernels/csrc/reprojection.cu, the
closed form of the retired Pallas kernel, with the calibration columns of
self-calibration), which covers every configuration ba_tpu accepts: the
linear, FOV, poly3 and equidistant models mixed freely across a rig, the
rig's or per-pose intrinsics, lm_size 0, 1 or 3, calib_size 0 or 5 with or
without T_vs; it raises by name for anything else.  The plain version runs
on CPU problems.  At lm_size 0 (a pose graph) a row is evaluated as a
world point's, x[:3] fixed, with no landmark columns and no same-pose
zeroing, as ba_tpu's `_residual_fn` does.

Residual: r = z - project(T_sv_meas^-1 T_wv_meas^-1 T_wv_ref T_vs_ref x_s)
with x_s the homogeneous inverse-depth landmark (lm_size==1) or the world
point (lm_size==3).  Tangent layout per row: [d_meas(6) | d_ref(6) |
d_lm(lm_size) | d_calib(calib_dim)], pose tangents [dt(3), dw(3)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from .. import camera, lie
from ..problem import BAConfig, Problem


class ProjEval(NamedTuple):
    r: torch.Tensor        # (Nr, 2)
    j_meas: torch.Tensor   # (Nr, 2, 6)
    j_ref: torch.Tensor    # (Nr, 2, 6)  (zeros in lm_size==3 mode)
    j_lm: torch.Tensor     # (Nr, 2, lm_size)
    j_cal: torch.Tensor    # (Nr, 2, calib_dim)
    err_sq: torch.Tensor   # (Nr,) squared pixel error


def _residual_fn(config: BAConfig):
    """Per-row residual-of-tangent function.  `cam_m` / `cam_r` are the
    measuring / reference-camera packs (params, model, tvs_q, tvs_t, opt);
    `opt` is 1 for the calibrated camera 0."""
    lm = config.lm_size
    cd = config.calib_dim
    cs = config.calib_size

    def r_of(delta, z, pose_m, pose_r, x, cam_m, cam_r, z_ref, has_z_ref):
        d_m, d_r = delta[0:6], delta[6:12]
        d_lm = delta[12:12 + lm]
        d_cal = delta[12 + lm:12 + lm + cd]

        params_m, model_m, tvs_qm, tvs_tm, opt_m = cam_m
        params_r, model_r, tvs_qr, tvs_tr, opt_r = cam_r

        q_m, t_m = lie.se3_retract(pose_m, d_m)
        if cs:
            dk = d_cal[:cs]
            params_m = torch.cat([params_m[:cs] + dk * opt_m, params_m[cs:]])
            params_r = torch.cat([params_r[:cs] + dk * opt_r, params_r[cs:]])
        if config.do_tvs:
            dtvs = d_cal[config.tvs_offset:config.tvs_offset + 6]
            tvs_qm, tvs_tm = lie.se3_retract((tvs_qm, tvs_tm), dtvs * opt_m)
            tvs_qr, tvs_tr = lie.se3_retract((tvs_qr, tvs_tr), dtvs * opt_r)

        if lm == 1:
            q_r, t_r = lie.se3_retract(pose_r, d_r)
            x_s = torch.cat([x[:3], x[3:4] + d_lm[0:1]])
            if cs:
                # self-calibration: the ray direction is the unprojection of
                # the reference-view pixel through the current intrinsics
                ray = camera.unproject(params_r, model_r, z_ref)
                x_s = torch.where(has_z_ref, torch.cat([ray, x_s[3:4]]), x_s)
            T_ws_ref = lie.se3_compose((q_r, t_r), (tvs_qr, tvs_tr))
            x_w = lie.se3_transform_homog(T_ws_ref, x_s)
        else:
            xyz = x[:3] + d_lm if lm == 3 else x[:3]
            x_w = torch.cat([xyz, torch.ones_like(x[3:4])])
        T_ws_meas = lie.se3_compose((q_m, t_m), (tvs_qm, tvs_tm))
        p_s = lie.se3_transform_homog(lie.se3_inverse(T_ws_meas), x_w)
        pix = camera.project(params_m, model_m, p_s[:3])
        return z - pix

    return r_of


def evaluate(problem: Problem, config: BAConfig,
             with_jacobians: bool = True) -> ProjEval:
    """Residuals (+ Jacobians) for every row of the projection table:
    the CUDA kernel for a problem on the card, the plain version on the
    CPU.  Invalid/padded rows produce zeros."""
    if problem.proj.z.is_cuda:
        return _evaluate_kernel(problem, config, with_jacobians)
    return evaluate_plain(problem, config, with_jacobians)


def _evaluate_kernel(problem, config, with_jacobians):
    if config.lm_size not in (0, 1, 3):
        raise NotImplementedError(
            f"reprojection kernel: lm_size {config.lm_size} is not 0, 1 "
            f"or 3")
    if config.calib_size not in (0, 5):
        raise NotImplementedError(
            f"reprojection kernel: calib_size {config.calib_size} is not 0 "
            f"or 5")
    from ...kernels import reprojection as kern

    r, j_meas, j_ref, j_lm, j_cal, err_sq = kern.reprojection(
        problem, with_jacobians, config.lm_size, config.calib_size,
        config.do_tvs, config.use_per_pose_cam_params)
    if not with_jacobians:
        z2 = r.new_zeros((r.shape[0], 2, 0))
        return ProjEval(r, z2, z2, z2, z2, err_sq)
    return ProjEval(r, j_meas, j_ref, j_lm, j_cal, err_sq)


def evaluate_plain(problem: Problem, config: BAConfig,
                   with_jacobians: bool = True) -> ProjEval:
    """The plain PyTorch version: vmap(jacfwd) of `_residual_fn`."""
    pr = problem.proj
    dtype = pr.z.dtype
    Nr = pr.z.shape[0]
    tdim = 12 + config.lm_size + config.calib_dim
    r_of = _residual_fn(config)

    poses = problem.poses
    rig = problem.rig
    pose_m = (poses.q[pr.pose], poses.t[pr.pose])
    ref_pose = problem.lms.ref_pose[pr.lm]
    ref_cam = problem.lms.ref_cam[pr.lm]
    pose_r = (poses.q[ref_pose], poses.t[ref_pose])
    x = problem.lms.x[pr.lm]
    if config.use_per_pose_cam_params:
        params_m = poses.cam_params[pr.pose]
        params_r = poses.cam_params[ref_pose]
    else:
        params_m = rig.params[pr.cam]
        params_r = rig.params[ref_cam]
    cam_m = (params_m, rig.model[pr.cam], rig.tvs_q[pr.cam],
             rig.tvs_t[pr.cam], (pr.cam == 0).to(dtype))
    cam_r = (params_r, rig.model[ref_cam], rig.tvs_q[ref_cam],
             rig.tvs_t[ref_cam], (ref_cam == 0).to(dtype))
    z_ref = problem.lms.z_ref[pr.lm]
    has_z_ref = problem.lms.has_z_ref[pr.lm]

    zeros = pr.z.new_zeros((Nr, tdim))
    args = (zeros, pr.z, pose_m, pose_r, x, cam_m, cam_r, z_ref, has_z_ref)
    r = vmap(r_of)(*args)

    valid = pr.valid
    r = torch.where(valid[:, None], r, 0.0)
    err_sq = torch.sum(r * r, dim=-1)

    if not with_jacobians:
        z2 = pr.z.new_zeros((Nr, 2, 0))
        return ProjEval(r, z2, z2, z2, z2, err_sq)

    # (Nr, 2, tdim); under jacfwd a 0-dim tensor times a Python float can
    # come back as float64 (torch 2.13 on the CPU), so keep the input type
    J = vmap(jacfwd(r_of))(*args).to(dtype)
    # measuring pose == reference pose contributes no pose gradient; also
    # mask invalid rows
    same = (pr.pose == ref_pose) & (config.lm_size == 1)
    jmask = (valid & ~same)[:, None, None]
    J = torch.where(valid[:, None, None], J, 0.0)
    j_meas = torch.where(jmask, J[..., 0:6], 0.0)
    j_ref = torch.where(jmask, J[..., 6:12], 0.0)
    j_lm = J[..., 12:12 + config.lm_size]
    j_cal = J[..., 12 + config.lm_size:]
    return ProjEval(r, j_meas, j_ref, j_lm, j_cal, err_sq)
