"""Synthetic VINS sequence generator (numpy copy of `ba_tpu/io/simulate_vins.py`).

A "curvy corridor walk": forward motion with lateral/vertical sinusoids and
a yaw wobble, landmarks scattered in a corridor around the path, exact gyro
and accel in the body frame from the analytic derivatives, FOV-camera
projections, noiseless by default.  The same seeds give the same problem as
the JAX package's builder: the pose perturbation goes through this
package's own f64 `lie`.

Camera rig: T_vs rotates the optical axis onto body +x (camera x = body y,
camera y = body z, camera z = body x).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

GRAVITY = 9.8007
FOV_CAM = np.array([198.969, 198.1284, 329.9368, 240.1017, 0.9640582])
IMG_W, IMG_H = 640, 480

# camera-from-vehicle rotation: columns are camera axes in body frame
R_VS = np.array([[0.0, 0.0, 1.0],
                 [1.0, 0.0, 0.0],
                 [0.0, 1.0, 0.0]])


def _rotz(c):
    return np.array([[np.cos(c), -np.sin(c), 0],
                     [np.sin(c), np.cos(c), 0],
                     [0, 0, 1.0]])


def _quat_from_matrix(R):
    """wxyz quaternion of a rotation matrix by the largest-pivot rule
    (the candidate and sign that scipy's `Rotation.from_matrix` picks)."""
    m = np.asarray(R, np.float64)
    decision = np.array([m[0, 0], m[1, 1], m[2, 2], np.trace(m)])
    choice = int(np.argmax(decision))
    q = np.empty(4)                       # xyzw
    if choice != 3:
        i = choice
        j = (i + 1) % 3
        k = (j + 1) % 3
        q[i] = 1 - decision[3] + 2 * m[i, i]
        q[j] = m[j, i] + m[i, j]
        q[k] = m[k, i] + m[i, k]
        q[3] = m[k, j] - m[j, k]
    else:
        q[0] = m[2, 1] - m[1, 2]
        q[1] = m[0, 2] - m[2, 0]
        q[2] = m[1, 0] - m[0, 1]
        q[3] = 1 + decision[3]
    q /= np.linalg.norm(q)
    return np.array([q[3], q[0], q[1], q[2]])


@dataclass
class SimData:
    """Ground truth + measurements for one synthetic sequence."""

    pose_times: np.ndarray      # (P,)
    q_wv: np.ndarray            # (P, 4) wxyz
    t_wv: np.ndarray            # (P, 3)
    v_w: np.ndarray             # (P, 3)
    lms_w: np.ndarray           # (L, 3)
    cam_params: np.ndarray      # (5,)
    tvs_q: np.ndarray           # (4,)
    tvs_t: np.ndarray           # (3,)
    # observations: list of (pose_idx, lm_idx, pixel)
    obs: list = field(default_factory=list)
    # imu spans between consecutive poses: list of (w (M,3), a (M,3), t (M,))
    imu_spans: list = field(default_factory=list)


def fov_project(params, p):
    fx, fy, cx, cy, w = params
    xn, yn = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
    r = np.sqrt(xn**2 + yn**2)
    r = np.maximum(r, 1e-12)
    factor = np.arctan(2 * r * np.tan(w / 2)) / (r * w)
    return np.stack([fx * factor * xn + cx, fy * factor * yn + cy], axis=-1)


def simulate(n_poses=200, n_lms=500, imu_per_span=10, speed=1.0,
             lat_amp=0.6, vert_amp=0.25, yaw_amp=0.25, seed=0,
             pixel_noise=0.0, max_obs_dist=12.0):
    """Generate a sequence (defaults: 200 poses, 500 landmarks, 10 IMU
    samples per keyframe interval)."""
    rng = np.random.default_rng(seed)
    dt_kf = 0.5
    times = np.arange(n_poses) * dt_kf

    w_lat, w_vert, w_yaw = 0.5, 0.7, 0.35

    def p_of(t):
        return np.stack([speed * t,
                         lat_amp * np.sin(w_lat * t),
                         vert_amp * np.cos(w_vert * t)], axis=-1)

    def v_of(t):
        return np.stack([np.full_like(t, speed),
                         lat_amp * w_lat * np.cos(w_lat * t),
                         -vert_amp * w_vert * np.sin(w_vert * t)], axis=-1)

    def a_of(t):
        return np.stack([np.zeros_like(t),
                         -lat_amp * w_lat**2 * np.sin(w_lat * t),
                         -vert_amp * w_vert**2 * np.cos(w_vert * t)],
                        axis=-1)

    def yaw_of(t):
        return yaw_amp * np.sin(w_yaw * t)

    def yaw_rate_of(t):
        return yaw_amp * w_yaw * np.cos(w_yaw * t)

    g = np.array([0.0, 0.0, -GRAVITY])

    q_wv = np.stack([_quat_from_matrix(_rotz(y)) for y in yaw_of(times)])
    t_wv = p_of(times)
    v_w = v_of(times)

    # landmarks in a corridor around the path
    length = speed * times[-1]
    lms = np.stack([
        rng.uniform(-2.0, length + 4.0, n_lms),
        rng.uniform(-4.0, 4.0, n_lms),
        rng.uniform(-2.0, 2.0, n_lms),
    ], axis=-1)
    # keep landmarks off the path centerline so depths stay positive
    lat = np.abs(lms[:, 1])
    lms[:, 1] = np.where(lat < 0.9, np.sign(lms[:, 1] + 1e-9) * 0.9 + lms[:, 1],
                         lms[:, 1])

    sim = SimData(pose_times=times, q_wv=q_wv, t_wv=t_wv, v_w=v_w,
                  lms_w=lms, cam_params=FOV_CAM.copy(),
                  tvs_q=_quat_from_matrix(R_VS), tvs_t=np.zeros(3))

    for i in range(n_poses):
        R_wv = _rotz(yaw_of(times[i]))
        R_ws = R_wv @ R_VS
        p_s = (lms - t_wv[i]) @ R_ws  # = R_ws^T (lm - t)
        depth_ok = p_s[:, 2] > 0.5
        dist_ok = np.linalg.norm(p_s, axis=-1) < max_obs_dist
        pix = fov_project(FOV_CAM, np.where(depth_ok[:, None], p_s,
                                            np.array([0, 0, 1.0])))
        in_img = ((pix[:, 0] >= 1) & (pix[:, 0] < IMG_W - 1)
                  & (pix[:, 1] >= 1) & (pix[:, 1] < IMG_H - 1))
        vis = depth_ok & dist_ok & in_img
        for j in np.flatnonzero(vis):
            z = pix[j]
            if pixel_noise:
                z = z + rng.normal(size=2) * pixel_noise
            sim.obs.append((i, int(j), z))

    # IMU spans (exact body-frame measurements from the analytic derivatives)
    for i in range(n_poses - 1):
        ts = np.linspace(times[i], times[i + 1], imu_per_span + 1)
        R_t = [_rotz(y) for y in yaw_of(ts)]
        w_meas = np.stack([[0.0, 0.0, yr] for yr in yaw_rate_of(ts)])
        a_meas = np.stack([R.T @ (aa - g)
                           for R, aa in zip(R_t, a_of(ts))])
        sim.imu_spans.append((w_meas, a_meas, ts))

    return sim


def build_problem(sim: SimData, config, n_window=None, n_anchor=2,
                  perturb=0.0, seed=0, pad_multiple=1,
                  with_marg_prior=True, device="cuda"):
    """Build a BA problem from a (sub)sequence on `device` (CUDA by default;
    raises when CUDA is absent and `device` is not "cpu").

    `n_window` selects the first n poses; `perturb` perturbs active pose
    states and landmark depths.  Landmark reference pose = first observing
    pose.  Returns (problem, pose_ids, lm_ids).
    """
    from .. import resolve_device
    from ..core import camera as cam_mod
    from ..core import lie
    from ..core.problem import ProblemBuilder

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    P = n_window or len(sim.pose_times)
    b = ProblemBuilder(config)
    cam = b.add_camera(sim.cam_params, cam_mod.MODEL_FOV,
                       tvs_q=sim.tvs_q, tvs_t=sim.tvs_t)

    obs_in_window = [(i, j, z) for (i, j, z) in sim.obs if i < P]
    first_seen = {}
    for (i, j, z) in obs_in_window:
        if j not in first_seen or i < first_seen[j]:
            first_seen[j] = i

    pose_ids = []
    for i in range(P):
        active = i >= n_anchor
        q = sim.q_wv[i].copy()
        t = sim.t_wv[i].copy()
        v = sim.v_w[i].copy()
        if active and perturb:
            dq = lie.so3_exp(torch.as_tensor(rng.normal(size=3) * perturb,
                                             dtype=torch.float64))
            q = lie.quat_mul(torch.as_tensor(q, dtype=torch.float64),
                             dq).numpy()
            t = t + rng.normal(size=3) * perturb
            v = v + rng.normal(size=3) * perturb
        pose_ids.append(b.add_pose(q, t, v=v, active=active,
                                   time=float(sim.pose_times[i])))

    lm_ids = {}
    for j, ref in first_seen.items():
        x_w = sim.lms_w[j].copy()
        if perturb:
            # depth-only perturbation along the ray from the reference pose
            c = sim.t_wv[ref]
            x_w = c + (x_w - c) * (1.0 + rng.normal() * perturb)
        lm_ids[j] = b.add_landmark(x_w, ref_pose=pose_ids[ref], ref_cam=cam)

    for (i, j, z) in obs_in_window:
        b.add_projection_residual(z, pose_ids[i], lm_ids[j], cam)

    if config.pose_dim >= 9:
        for i in range(P - 1):
            w, a, ts = sim.imu_spans[i]
            b.add_imu_residual(pose_ids[i], pose_ids[i + 1], w, a, ts)

    return (b.build(pad_multiple=pad_multiple,
                    with_marg_prior=with_marg_prior, device=dev),
            pose_ids, lm_ids)


def ate(q_est, t_est, q_gt, t_gt):
    """Absolute trajectory error (RMSE of position)."""
    err = np.linalg.norm(np.asarray(t_est) - np.asarray(t_gt), axis=-1)
    return float(np.sqrt(np.mean(err**2)))
