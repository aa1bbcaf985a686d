"""The program's problem from a scene, built in bulk.

`ProblemBuilder` takes one Python call per observation, which at BAL's
five million rows is most of a minute of set-up.  `problem` fills the
same `Problem` from the scene's arrays at once: the same fields, padding
rules, gauge mask and conditioning flags as `ProblemBuilder.build`, and
the sparsity tables from the program's own `build_structure_index`
(`tests/test_portbench_port_problem.py` holds the two equal, leaf by
leaf, at small sizes).  No marginalization prior is allocated: none of
the benchmark's solves has one.

So every cell times solves of a `Problem` laid out by this copy: a change
to the program's builder (its row order or padding) shows in no cell and
in no `setup_s` until the harness drives a bulk builder of the program's
own.
"""

from __future__ import annotations

import numpy as np
import torch

from .scene import Scene


def param_mask(scene: Scene, pose_dim: int) -> torch.Tensor:
    """(P, 15) optimized dims, as `ProblemBuilder._build_param_mask` with
    no manual masks: an active pose optimizes its first `pose_dim` dims,
    velocity and biases only with an IMU span, nothing without any
    residual."""
    P, dev = scene.n_poses, scene.q.device
    if bool(scene.active.all()):
        raise NotImplementedError("port.problem: every pose is active; the "
                                  "scenes fix their gauge with inactive "
                                  "poses")
    mask = torch.zeros((P, 15), dtype=torch.bool, device=dev)
    a = scene.active
    mask[:, :6] = a[:, None]
    if pose_dim >= 9:
        mask[:, 6:9] = a[:, None]
    if pose_dim >= 15:
        mask[:, 9:15] = a[:, None]
    inertial = torch.zeros(P, dtype=torch.bool, device=dev)
    inertial[scene.imu_pose1] = True
    inertial[scene.imu_pose2] = True
    mask[:, 6:15] &= inertial[:, None]
    anyres = inertial.clone()
    anyres[scene.obs_pose] = True
    anyres[scene.ref_pose[scene.obs_lm]] = True
    return mask & anyres[:, None]


def problem(scene: Scene, config, dtype: torch.dtype, device):
    """The program's `Problem` of `scene` in `dtype` on `device`, with
    `config` (a `BAConfig`) for the gauge mask.  Landmarks still need the
    program's `prepare_landmarks`."""
    from ba_tpu_torch.core import problem as pm

    dev = torch.device(device)

    def T(x, dt=None):
        x = x.to(dev)
        if dt is not None:
            return x.to(dt).contiguous()
        return (x.to(dtype) if x.is_floating_point() else x).contiguous()

    i32 = torch.int32
    P, L, N = scene.n_poses, scene.n_lms, scene.obs_pose.shape[0]
    Ni = scene.imu_pose1.shape[0]
    a = scene.active
    poses = pm.PoseStates(
        q=T(scene.q), t=T(scene.t), v=T(scene.v), b=T(scene.b),
        time=T(scene.time), active=T(a),
        mask=T(param_mask(scene, config.pose_dim)),
        cam_params=T(scene.cam_params))
    x_w = torch.cat([scene.x_w, torch.ones_like(scene.x_w[:, :1])], 1)
    lms = pm.LandmarkStates(
        x=torch.zeros((L, 4), dtype=dtype, device=dev), x_w=T(x_w),
        ref_pose=T(scene.ref_pose, i32), ref_cam=T(scene.ref_cam, i32),
        active=torch.ones(L, dtype=torch.bool, device=dev),
        reliable=torch.ones(L, dtype=torch.bool, device=dev),
        z_ref=T(scene.z_ref), has_z_ref=T(scene.has_z_ref))
    rig = pm.Rig(params=T(scene.cam), model=T(scene.cam_model, i32),
                 tvs_q=T(scene.tvs_q), tvs_t=T(scene.tvs_t))

    # the padded unary and binary tables: one invalid row each
    n_imu = max(Ni, 1)
    proj_ref = scene.ref_pose[scene.obs_lm]
    b1 = np.zeros(1, np.int32)
    i1 = np.zeros(n_imu, np.int32)
    i2 = np.zeros(n_imu, np.int32)
    i1[:Ni] = scene.imu_pose1.cpu().numpy()
    i2[:Ni] = scene.imu_pose2.cpu().numpy()
    i_valid = np.zeros(n_imu, bool)
    i_valid[:Ni] = True
    per_row, pidx = pm.build_structure_index(
        scene.obs_pose.cpu().numpy().astype(np.int32),
        proj_ref.cpu().numpy().astype(np.int32),
        scene.obs_lm.cpu().numpy().astype(np.int32), np.ones(N, bool),
        b1, b1, np.zeros(1, bool), i1, i2, i_valid, P, L, 1, device=dev)

    def rows(key, dt=None):
        x = torch.as_tensor(per_row[key], device=dev)
        return x if dt is None else x.to(dt)

    proj = pm.ProjResiduals(
        z=T(scene.obs_z), pose=T(scene.obs_pose, i32),
        lm=T(scene.obs_lm, i32), cam=T(scene.obs_cam, i32),
        weight=torch.ones(N, dtype=dtype, device=dev),
        valid=torch.ones(N, dtype=torch.bool, device=dev),
        cond=T(~a[proj_ref] & a[scene.obs_pose]),
        pair=rows("pair"), pair_swap=rows("pair_swap"),
        wb_meas=rows("wb_meas"), wb_ref=rows("wb_ref"))
    zi = torch.zeros(1, dtype=i32, device=dev)
    qid = torch.tensor([[1.0, 0, 0, 0]], dtype=dtype, device=dev)
    z3 = torch.zeros((1, 3), dtype=dtype, device=dev)
    z66 = torch.zeros((1, 6, 6), dtype=dtype, device=dev)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    unary = pm.UnaryResiduals(pose=zi, q=qid, t=z3, cov_inv=z66, valid=no)
    binary = pm.BinaryResiduals(pose1=zi, pose2=zi.clone(), q=qid.clone(),
                                t=z3.clone(), cov_inv=z66.clone(),
                                valid=no.clone(), pair=rows("bpair"),
                                pair_swap=rows("bswap"))
    M = scene.imu_w.shape[1] if Ni else 1
    w = torch.zeros((n_imu, M, 3), dtype=dtype, device=dev)
    acc = torch.zeros((n_imu, M, 3), dtype=dtype, device=dev)
    tim = torch.zeros((n_imu, M), dtype=dtype, device=dev)
    if Ni:
        w[:Ni], acc[:Ni], tim[:Ni] = (T(scene.imu_w), T(scene.imu_a),
                                      T(scene.imu_time))
    imu = pm.ImuResiduals(
        pose1=torch.as_tensor(i1, device=dev),
        pose2=torch.as_tensor(i2, device=dev), w=w, a=acc, time=tim,
        meas_valid=torch.as_tensor(np.broadcast_to(i_valid[:, None],
                                                   (n_imu, M)).copy(),
                                   device=dev),
        weight=torch.ones(n_imu, dtype=dtype, device=dev),
        valid=torch.as_tensor(i_valid, device=dev),
        cond=T(torch.cat([~a[scene.imu_pose1] & a[scene.imu_pose2],
                          torch.zeros(n_imu - Ni, dtype=torch.bool,
                                      device=a.device)])),
        pair=rows("ipair"), pair_swap=rows("iswap"),
        c9=torch.zeros((n_imu, 9, 9), dtype=dtype, device=dev),
        c9_set=torch.zeros((), dtype=torch.bool, device=dev))
    marg = pm.empty_marg_prior(P, config.pose_dim, dtype, dev, enabled=False)
    marg = pm.MargPrior(H=marg.H, g=marg.g, lin_q=poses.q, lin_t=poses.t,
                        lin_v=poses.v, lin_b=poses.b, active=marg.active)
    return pm.Problem(poses=poses, lms=lms, rig=rig, proj=proj, unary=unary,
                      binary=binary, imu=imu, g_vec=T(scene.gravity),
                      marg=marg, pidx=pidx)
