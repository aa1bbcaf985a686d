"""A BAL-shaped scene at a BAL problem's published counts.

The configuration gives the counts (cameras, points, observations); the
scene is synthesized from the seed on the device, so nothing is fetched:

  * cameras on a square survey grid (spacing `grid_m`), looking down from
    `altitude_m` with a few degrees of random tilt, each with its own BAL
    intrinsics (f, k1, k2; poly3 with k3 = 0, no principal-point offset);
  * points over the grid with `relief_m` of height; a point of track
    length k is seen by the k cameras nearest to it;
  * track lengths: the fixed quantiles of a shifted geometric law (at
    least 2, capped at `max_track`, mean = observations / points), adjusted
    to the exact observation count, then shuffled by the seed, so every
    seed solves the same sizes;
  * pixels: the true projection plus Gaussian noise of `pixel_sigma`;
  * the start: rotations, translations and points perturbed by the mix's
    `perturb` sigmas; the first `fixed_cameras` cameras are inactive (the
    gauge) and keep their true pose.
"""

from __future__ import annotations

import math

import torch

from ..reference import geometry as geo
from .scene import Scene


def track_lengths(n_points: int, n_obs: int, max_track: int):
    """Deterministic track lengths (n_points,) int64 summing to n_obs: the
    quantiles of 2 + Geometric with the mean n_obs / n_points, capped."""
    mean_extra = n_obs / n_points - 2.0
    lam = math.log1p(1.0 / mean_extra)           # P(G >= g) = exp(-lam g)
    u = (torch.arange(n_points, dtype=torch.float64) + 0.5) / n_points
    k = 2 + torch.floor(-torch.log1p(-u) / lam).long()
    k = k.clamp(max=max_track)
    # the exact total: +1 on the shortest tracks or -1 on the longest
    d = n_obs - int(k.sum())
    order = torch.argsort(k, stable=True)
    while d != 0:
        if d > 0:
            idx = order[: min(d, n_points)]
            idx = idx[k[idx] < max_track]
            k[idx] += 1
        else:
            idx = order.flip(0)[: min(-d, n_points)]
            idx = idx[k[idx] > 2]
            k[idx] -= 1
        d = n_obs - int(k.sum())
        order = torch.argsort(k, stable=True)
    return k


def _nearest_cameras(pts_xy, cam_xy, cols, rows, grid, k, device,
                     chunk=65536):
    """For each point, the ids of its k nearest cameras (k <= max_track),
    ordered by distance, padded with -1: (n, max(k))."""
    n = pts_xy.shape[0]
    kmax = int(k.max())
    half = math.ceil(math.sqrt(kmax)) // 2 + 3
    off = torch.arange(-half, half + 1, device=device)
    oc, orr = torch.meshgrid(off, off, indexing="xy")
    oc, orr = oc.reshape(-1), orr.reshape(-1)
    n_cams = cam_xy.shape[0]
    out = torch.full((n, kmax), -1, dtype=torch.long, device=device)
    for s in range(0, n, chunk):
        p = pts_xy[s: s + chunk]
        ci = torch.floor(p[:, 0] / grid).long()[:, None] + oc[None]
        ri = torch.floor(p[:, 1] / grid).long()[:, None] + orr[None]
        ids = ri * cols + ci
        ok = (ci >= 0) & (ci < cols) & (ri >= 0) & (ri < rows) \
            & (ids < n_cams)
        ids = torch.where(ok, ids, 0)
        d2 = ((cam_xy[ids] - p[:, None]) ** 2).sum(-1)
        d2 = torch.where(ok, d2, float("inf"))
        order = torch.argsort(d2, dim=1)[:, :kmax]
        near = torch.gather(ids, 1, order)
        good = torch.gather(ok, 1, order)
        take = torch.arange(kmax, device=device)[None] < k[s: s + chunk, None]
        if not bool((good | ~take).all()):
            raise ValueError("bal scene: a point has fewer candidate cameras "
                             "than its track length")
        out[s: s + chunk] = torch.where(take, near, -1)
    return out


def generate(config: dict, mix: dict, seed: int, device) -> Scene:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)
    geom = config["geometry"]
    n_cams, n_pts, n_obs = (config["cameras"], config["points"],
                            config["observations"])
    grid, alt = geom["grid_m"], geom["altitude_m"]

    def randn(*shape):
        return torch.randn(*shape, generator=g, **f64)

    def rand(*shape):
        return torch.rand(*shape, generator=g, **f64)

    # cameras: a survey grid, nadir with a few degrees of tilt
    cols = math.ceil(math.sqrt(n_cams))
    rows = math.ceil(n_cams / cols)
    cid = torch.arange(n_cams, device=device)
    cam_xy = torch.stack([(cid % cols + 0.5) * grid,
                          (cid // cols + 0.5) * grid], -1).double()
    cam_xy = cam_xy + (rand(n_cams, 2) - 0.5) * geom["jitter_m"]
    c_pos = torch.cat([cam_xy, alt + randn(n_cams, 1) * geom["alt_sigma_m"]],
                      -1)
    nadir = torch.tensor([0.0, 1.0, 0.0, 0.0], **f64)     # 180 deg about x
    tilt = randn(n_cams, 3) * math.radians(geom["tilt_deg"])
    q_true = geo.quat_mul(geo.so3_exp(tilt), nadir.expand(n_cams, 4))
    # intrinsics per camera: [f, f, 0, 0, k1, k2, 0]
    intr = geom["intrinsics"]
    f = intr["f_px"][0] + rand(n_cams) * (intr["f_px"][1] - intr["f_px"][0])
    k1 = intr["k1"][0] + rand(n_cams) * (intr["k1"][1] - intr["k1"][0])
    k2 = intr["k2"][0] + rand(n_cams) * (intr["k2"][1] - intr["k2"][0])
    z = torch.zeros_like(f)
    cam_params = torch.stack([f, f, z, z, k1, k2, z], -1)

    # points and their tracks
    k = track_lengths(n_pts, n_obs, geom["max_track"]).to(device)
    k = k[torch.randperm(n_pts, generator=g, device=device)]
    # points only over complete grid rows, so every point has its k cameras
    ext = torch.tensor([cols * grid, (n_cams // cols) * grid], **f64)
    p_xy = rand(n_pts, 2) * (ext - 2 * grid) + grid
    p_z = rand(n_pts, 1) * geom["relief_m"]
    x_true = torch.cat([p_xy, p_z], -1)
    near = _nearest_cameras(p_xy, cam_xy, cols, rows, grid, k, device)
    lm = torch.arange(n_pts, device=device)[:, None].expand_as(near)
    keep = near >= 0
    obs_pose, obs_lm = near[keep], lm[keep]
    # rows grouped by point, each point's cameras in ascending order, as
    # BAL files list them
    order = torch.argsort(obs_lm * n_cams + obs_pose)
    obs_pose, obs_lm = obs_pose[order], obs_lm[order]
    if obs_pose.shape[0] != n_obs:
        raise ValueError(f"bal scene: {obs_pose.shape[0]} rows, not {n_obs}")

    # true pixels + noise; the camera is the vehicle (T_vs = identity)
    t_true = c_pos
    p_s = geo.rotate(geo.quat_conj(q_true[obs_pose]),
                     x_true[obs_lm] - t_true[obs_pose])
    if bool((p_s[:, 2] <= 1.0).any()):
        raise ValueError("bal scene: a point lies behind an observing camera")
    pix = geo.project_poly3(cam_params[obs_pose], p_s)
    obs_z = pix + randn(n_obs, 2) * geom["pixel_sigma"]

    # the start: perturbed active cameras and every point
    per = mix["perturb"]
    n_fix = geom["fixed_cameras"]
    active = cid >= n_fix
    a = active[:, None].double()
    q0 = geo.quat_mul(q_true, geo.so3_exp(
        randn(n_cams, 3) * per["rotation_rad"] * a))
    t0 = t_true + randn(n_cams, 3) * per["translation_m"] * a
    x0 = x_true + randn(n_pts, 3) * per["point_m"]
    # each point's reference pose: its last observing camera
    ref_pose = torch.zeros(n_pts, dtype=torch.long, device=device)
    ref_pose.scatter_reduce_(0, obs_lm, obs_pose, reduce="amax",
                             include_self=False)

    zl = torch.zeros(n_pts, 2, **f64)
    P = n_cams
    return Scene(
        q=q0, t=t0, v=torch.zeros(P, 3, **f64), b=torch.zeros(P, 6, **f64),
        time=torch.zeros(P, **f64), active=active, cam_params=cam_params,
        cam=torch.zeros(1, 7, **f64),
        cam_model=torch.full((1,), 2, dtype=torch.long, device=device),
        tvs_q=torch.tensor([[1.0, 0, 0, 0]], **f64),
        tvs_t=torch.zeros(1, 3, **f64),
        x_w=x0, ref_pose=ref_pose,
        ref_cam=torch.zeros(n_pts, dtype=torch.long, device=device),
        z_ref=zl, has_z_ref=torch.zeros(n_pts, dtype=torch.bool,
                                        device=device),
        obs_z=obs_z, obs_pose=obs_pose, obs_lm=obs_lm,
        obs_cam=torch.zeros(n_obs, dtype=torch.long, device=device),
        imu_pose1=torch.zeros(0, dtype=torch.long, device=device),
        imu_pose2=torch.zeros(0, dtype=torch.long, device=device),
        imu_w=torch.zeros(0, 1, 3, **f64), imu_a=torch.zeros(0, 1, 3, **f64),
        imu_time=torch.zeros(0, 1, **f64),
        gravity=torch.tensor([0.0, 0.0, -9.81], **f64),
        inverse_depth=False, per_pose_intrinsics=True, windows=1)
