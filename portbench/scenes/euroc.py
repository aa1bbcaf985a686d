"""An EuRoC-rate stereo visual-inertial scene.

The configuration gives the dataset's rates and calibration (keyframes,
IMU rate, image size, the two cameras, features per image, track
lengths); the mix cuts the sequence: `vehicles` windows of
`window_keyframes` each (a fleet, fused into one problem of equal,
independent windows) or, with `vehicles` 1 and no window, the whole
sequence.  Synthesized from the seed on the device:

  * each vehicle flies its own copy of the curvy corridor path of
    `ba_tpu_torch/io/simulate_vins.py` (forward at `speed`, lateral and
    vertical sinusoids, a yaw wobble), its amplitudes and phases drawn
    from the seed, sampled at the keyframe rate from a random start time;
  * a fixed track schedule: `features` slots per keyframe, each running
    back-to-back tracks whose lengths cycle through 2-20 keyframes, so
    every window and every seed has the same landmarks and rows; a track's
    landmark lies on a random cam0 pixel of its middle keyframe at a
    random depth, and is seen by both cameras at every keyframe of the
    track (its first cam0 view is the reference pixel);
  * IMU samples from the path's analytic derivatives at the IMU rate, with
    constant biases drawn per vehicle and white noise at the configured
    densities; each span's sample times on its own clock from 0 (the solve
    reads only their differences, which the configuration's float32 then
    holds to its rounding);
  * the start: every keyframe but the first `fixed_keyframes` of a window
    perturbed (rotation, translation, velocity), biases at zero, landmark
    depths scaled along their reference ray.
"""

from __future__ import annotations

import math

import torch

from ..reference import geometry as geo
from .scene import Scene

# camera-from-vehicle rotation: the optical axis on body +x (camera x =
# body y, camera y = body z, camera z = body x), as the simulator's rig
R_VS = [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]


def track_schedule(n_kf: int, slots: int, lo: int, hi: int):
    """(start, length) of every track of one window of n_kf keyframes:
    slot s runs tracks of lengths lo + (3 s + 7 j) mod (hi - lo + 1),
    j = 0, 1, ..., from keyframe (s mod lo); a track cut by the window's
    end keeps what lies inside when that is at least lo keyframes."""
    span = hi - lo + 1
    starts, lens = [], []
    for s in range(slots):
        k, j = s % lo, 0
        while k < n_kf:
            ln = min(lo + (3 * s + 7 * j) % span, n_kf - k)
            if ln >= lo:
                starts.append(k)
                lens.append(ln)
            k += ln
            j += 1
    return torch.tensor(starts), torch.tensor(lens)


def _path(t, amp, ph, speed):
    """Position, velocity, acceleration, yaw and yaw rate of the corridor
    path at times t (n,) for one vehicle's amplitudes and phases."""
    wl, wv, wy = 0.5, 0.7, 0.35
    la, va, ya = amp
    pl, pv, py = ph
    p = torch.stack([speed * t, la * torch.sin(wl * t + pl),
                     va * torch.cos(wv * t + pv)], -1)
    v = torch.stack([torch.full_like(t, speed),
                     la * wl * torch.cos(wl * t + pl),
                     -va * wv * torch.sin(wv * t + pv)], -1)
    a = torch.stack([torch.zeros_like(t),
                     -la * wl ** 2 * torch.sin(wl * t + pl),
                     -va * wv ** 2 * torch.cos(wv * t + pv)], -1)
    yaw = ya * torch.sin(wy * t + py)
    rate = ya * wy * torch.cos(wy * t + py)
    return p, v, a, yaw, rate


def generate(config: dict, mix: dict, seed: int, device) -> Scene:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)
    i64 = dict(dtype=torch.long, device=device)

    def randn(*shape):
        return torch.randn(*shape, generator=g, **f64)

    def rand(*shape):
        return torch.rand(*shape, generator=g, **f64)

    seq, geom = config["sequence"], config["geometry"]
    kf_hz, imu_hz = seq["keyframe_hz"], seq["imu_hz"]
    n_seq = int(round(seq["seconds"] * kf_hz))
    V = mix["vehicles"]
    K = mix.get("window_keyframes") or n_seq
    P = V * K
    per_span = int(round(imu_hz / kf_hz))          # samples between keyframes
    M = per_span + 1

    # each vehicle's path and its window's start time
    amp = torch.tensor([geom["lat_amp_m"], geom["vert_amp_m"],
                        geom["yaw_amp_rad"]], **f64) \
        * (0.7 + 0.6 * rand(V, 3))
    ph = rand(V, 3) * 2 * math.pi
    t_free = max(seq["seconds"] - K / kf_hz, 0.0)
    t0 = rand(V) * t_free
    kt = torch.arange(K, **f64) / kf_hz
    times = t0[:, None] + kt[None]                              # (V, K)
    speed = geom["speed_mps"]
    pos, vel, yaw = [], [], []
    for vv in range(V):
        p, v, _, y, _ = _path(times[vv], amp[vv], ph[vv], speed)
        pos.append(p)
        vel.append(v)
        yaw.append(y)
    pos, vel, yaw = torch.cat(pos), torch.cat(vel), torch.cat(yaw)
    q_true = geo.matrix_to_quat(geo.rot_z(yaw))
    bias = torch.cat([randn(V, 3) * geom["gyro_bias"],
                      randn(V, 3) * geom["accel_bias"]], -1)

    # the rig
    cams = config["cameras"]
    cam = torch.tensor([c["params"] for c in cams], **f64)
    r_vs = torch.tensor(R_VS, **f64)
    q_vs = geo.matrix_to_quat(r_vs)
    tvs_q = q_vs.expand(len(cams), 4).clone()
    tvs_t = torch.stack([r_vs @ torch.tensor([c["baseline_m"], 0.0, 0.0],
                                             **f64) for c in cams])

    # tracks: the same schedule in every window
    starts, lens = track_schedule(K, geom["features"], geom["track_min"],
                                  geom["track_max"])
    starts, lens = starts.to(device), lens.to(device)
    Lw = starts.shape[0]
    L = V * Lw
    win = torch.arange(V, device=device).repeat_interleave(Lw)
    k_ref = starts.repeat(V) + win * K                          # global pose
    k_mid = (starts + (lens - 1) // 2).repeat(V) + win * K
    lens_all = lens.repeat(V)
    w_img, h_img = seq["image_px"]
    m = geom["margin_px"]
    pix = torch.stack([m + rand(L) * (w_img - 2 * m),
                       m + rand(L) * (h_img - 2 * m)], -1)
    depth = geom["depth_m"][0] + rand(L) * (geom["depth_m"][1]
                                            - geom["depth_m"][0])
    ray = geo.unproject_poly3(cam[0].expand(L, 7), pix)
    p_s = ray / ray[:, 2:3] * depth[:, None]
    x_true = geo.from_sensor(q_true[k_mid], pos[k_mid], tvs_q[0].expand(L, 4),
                             tvs_t[0].expand(L, 3), p_s,
                             torch.ones(L, 1, **f64))

    # observations: both cameras at every keyframe of a track; cam0 at the
    # reference keyframe is the reference pixel, not a row
    lm_of = torch.arange(L, device=device).repeat_interleave(lens_all)
    off = torch.arange(int(lens_all.sum()), device=device) \
        - (torch.cumsum(lens_all, 0) - lens_all).repeat_interleave(lens_all)
    kf_of = k_ref[lm_of] + off
    n_cam = len(cams)
    obs_lm = lm_of.repeat_interleave(n_cam)
    obs_pose = kf_of.repeat_interleave(n_cam)
    obs_cam = torch.arange(n_cam, device=device).repeat(lm_of.shape[0])
    s = geo.to_sensor(q_true[obs_pose], pos[obs_pose], tvs_q[obs_cam],
                      tvs_t[obs_cam], x_true[obs_lm])
    if bool((s[:, 2] <= 0.2).any()):
        raise ValueError("euroc scene: a landmark lies behind a camera")
    z = geo.project_poly3(cam[obs_cam], s) + randn(s.shape[0], 2) \
        * geom["pixel_sigma"]
    is_ref = (obs_pose == k_ref[obs_lm]) & (obs_cam == 0)
    z_ref = torch.zeros(L, 2, **f64)
    z_ref[obs_lm[is_ref]] = z[is_ref]
    keep = ~is_ref
    obs_z, obs_pose, obs_lm, obs_cam = (z[keep], obs_pose[keep],
                                        obs_lm[keep], obs_cam[keep])

    # IMU spans between consecutive keyframes of a window
    kk = torch.arange(P, device=device)
    i1 = kk[(kk % K) < K - 1]
    i2 = i1 + 1
    Ni = i1.shape[0]
    ts = (times.reshape(-1)[i1][:, None]
          + torch.arange(M, **f64)[None] / imu_hz)              # (Ni, M)
    veh = i1 // K
    gvec = torch.tensor([0.0, 0.0, -seq["gravity"]], **f64)
    w_meas = torch.empty(Ni, M, 3, **f64)
    a_meas = torch.empty(Ni, M, 3, **f64)
    for vv in range(V):
        sel = veh == vv
        tv = ts[sel].reshape(-1)
        _, _, acc, y, rate = _path(tv, amp[vv], ph[vv], speed)
        R = geo.rot_z(y)
        w = torch.stack([torch.zeros_like(rate), torch.zeros_like(rate),
                         rate], -1)
        a = (R.mT @ (acc - gvec)[..., None])[..., 0]
        w_meas[sel] = (w - bias[vv, :3]).reshape(-1, M, 3)
        a_meas[sel] = (a - bias[vv, 3:]).reshape(-1, M, 3)
    dt = 1.0 / imu_hz
    imu = config["solver"]["imu"]
    w_meas = w_meas + randn(Ni, M, 3) * imu["gyro_sigma"] / math.sqrt(dt)
    a_meas = a_meas + randn(Ni, M, 3) * imu["accel_sigma"] / math.sqrt(dt)

    # the start
    per = mix["perturb"]
    active = (kk % K) >= geom["fixed_keyframes"]
    a_ = active[:, None].double()
    q0 = geo.quat_mul(q_true, geo.so3_exp(randn(P, 3) * per["rotation_rad"]
                                          * a_))
    pos0 = pos + randn(P, 3) * per["translation_m"] * a_
    vel0 = vel + randn(P, 3) * per["velocity_mps"] * a_
    c = pos[k_ref]
    x0 = c + (x_true - c) * (1.0 + randn(L, 1) * per["depth_rel"])
    b_true = bias[kk // K]
    b0 = torch.where(active[:, None], torch.zeros_like(b_true), b_true)

    return Scene(
        q=q0, t=pos0, v=vel0, b=b0, time=times.reshape(-1), active=active,
        cam_params=torch.zeros(P, 7, **f64), cam=cam,
        cam_model=torch.full((n_cam,), 2, **i64), tvs_q=tvs_q, tvs_t=tvs_t,
        x_w=x0, ref_pose=k_ref, ref_cam=torch.zeros(L, **i64), z_ref=z_ref,
        has_z_ref=torch.ones(L, dtype=torch.bool, device=device),
        obs_z=obs_z, obs_pose=obs_pose, obs_lm=obs_lm, obs_cam=obs_cam,
        imu_pose1=i1, imu_pose2=i2, imu_w=w_meas, imu_a=a_meas,
        imu_time=ts - ts[:, :1], gravity=gvec, inverse_depth=True,
        per_pose_intrinsics=False, windows=V)
