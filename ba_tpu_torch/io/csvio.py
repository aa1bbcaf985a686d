"""Reference-compatible CSV I/O for synthetic VINS sequences (numpy copy of
`ba_tpu/io/csvio.py`, reading into and writing from this package's
`SimData`).

The reference's offline generator writes five files
(the reference's matlab/simulate_vins.py:236-240):

  points.csv      "%.12f,%d, %d, %d, %.12f, %.12f"  -> time, pose_idx,
                  point_idx, cam_id, u, v
  accel.csv       "%.12f, %.12f, %.12f, %.12f"      -> time, ax, ay, az
  gyro.csv        "%.12f, %.12f, %.12f, %.12f"      -> time, wx, wy, wz
  poses.csv       "%.12f, ..." x 6                  -> x, y, z, r, p, q
                  (ZYX Euler: R = Rz(q) Ry(p) Rx(r), simulate_vins.py:18-35)
  timestamps.csv  "%.12f"

plus an axis permutation P = [[0,0,1],[1,0,0],[0,1,0]] applied to the
body-frame gyro/accel before writing (simulate_vins.py:151-156).  This
module writes/reads that exact format so the reference, the JAX package
and this port can consume identical inputs.  Gravity/accelerometer sign
follows this engine's integrator convention (a_meas = R^T (a_w - g_vec),
g_vec = (0,0,-9.8007)).
"""

from __future__ import annotations

import os

import numpy as np

from .simulate_vins import SimData, _quat_from_matrix

# body->IMU axis permutation used by the reference generator
PERM = np.array([[0.0, 0.0, 1.0],
                 [1.0, 0.0, 0.0],
                 [0.0, 1.0, 0.0]])


def euler_zyx_to_matrix(r, p, q):
    """R = Rz(q) Ry(p) Rx(r) (reference cart_2_r, simulate_vins.py:18-28)."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cq, sq = np.cos(q), np.sin(q)
    return np.array([
        [cp * cq, -cr * sq + sr * sp * cq, sr * sq + cr * sp * cq],
        [cp * sq, cr * cq + sr * sp * sq, -sr * cq + cr * sp * sq],
        [-sp, sr * cp, cr * cp]])


def matrix_to_euler_zyx(R):
    """Inverse of euler_zyx_to_matrix (r, p, q)."""
    p = -np.arcsin(np.clip(R[2, 0], -1.0, 1.0))
    r = np.arctan2(R[2, 1], R[2, 2])
    q = np.arctan2(R[1, 0], R[0, 0])
    return r, p, q


def _quat_to_matrix(qv):
    w, x, y, z = qv
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def write_csv(sim: SimData, out_dir: str) -> None:
    """Write the five reference-format files from a simulated sequence."""
    os.makedirs(out_dir, exist_ok=True)

    tracks = np.array([[sim.pose_times[i], i, j, 0, z[0], z[1]]
                       for (i, j, z) in sim.obs])
    np.savetxt(os.path.join(out_dir, "points.csv"), tracks,
               fmt="%.12f,%d, %d, %d, %.12f, %.12f")

    # flatten IMU spans, dropping each span's duplicated first sample
    # (span k starts at span k-1's endpoint)
    times, w_rows, a_rows = [], [], []
    for k, (w, a, ts) in enumerate(sim.imu_spans):
        s = 0 if k == 0 else 1
        times.extend(ts[s:])
        w_rows.extend(w[s:])
        a_rows.extend(a[s:])
    times = np.asarray(times)
    w_imu = np.asarray(w_rows) @ PERM.T
    a_imu = np.asarray(a_rows) @ PERM.T
    np.savetxt(os.path.join(out_dir, "gyro.csv"),
               np.c_[times, w_imu], fmt="%.12f, %.12f, %.12f, %.12f")
    np.savetxt(os.path.join(out_dir, "accel.csv"),
               np.c_[times, a_imu], fmt="%.12f, %.12f, %.12f, %.12f")

    poses = np.zeros((len(sim.pose_times), 6))
    for i in range(len(sim.pose_times)):
        poses[i, :3] = sim.t_wv[i]
        poses[i, 3:] = matrix_to_euler_zyx(_quat_to_matrix(sim.q_wv[i]))
    np.savetxt(os.path.join(out_dir, "poses.csv"), poses,
               fmt="%.12f, %.12f, %.12f, %.12f, %.12f, %.12f")
    np.savetxt(os.path.join(out_dir, "timestamps.csv"), sim.pose_times,
               fmt="%.12f")


def read_csv(in_dir: str, cam_params=None, tvs_q=None, tvs_t=None,
             imu_per_span=None) -> SimData:
    """Read a reference-format sequence directory back into SimData.

    The five files carry no camera intrinsics or extrinsics (the reference
    hardcodes them in the consumer); pass them explicitly or accept this
    generator's defaults.  Landmark positions are not stored either, so
    `lms_w` is left empty — consumers triangulate or use `build_problem`'s
    observation-only path.
    """
    from .simulate_vins import FOV_CAM, R_VS

    tracks = np.loadtxt(os.path.join(in_dir, "points.csv"), delimiter=",")
    gyro = np.loadtxt(os.path.join(in_dir, "gyro.csv"), delimiter=",")
    accel = np.loadtxt(os.path.join(in_dir, "accel.csv"), delimiter=",")
    poses = np.loadtxt(os.path.join(in_dir, "poses.csv"), delimiter=",")
    times = np.loadtxt(os.path.join(in_dir, "timestamps.csv"))

    n = len(times)
    q_wv = np.zeros((n, 4))
    for i in range(n):
        R = euler_zyx_to_matrix(*poses[i, 3:])
        q_wv[i] = _quat_from_matrix(R)

    n_lms = int(tracks[:, 2].max()) + 1 if len(tracks) else 0
    sim = SimData(pose_times=times, q_wv=q_wv, t_wv=poses[:, :3],
                  v_w=np.zeros((n, 3)),
                  lms_w=np.zeros((n_lms, 3)),
                  cam_params=(np.asarray(cam_params) if cam_params
                              is not None else FOV_CAM.copy()),
                  tvs_q=(np.asarray(tvs_q) if tvs_q is not None
                         else _quat_from_matrix(R_VS)),
                  tvs_t=(np.asarray(tvs_t) if tvs_t is not None
                         else np.zeros(3)))
    for row in tracks:
        sim.obs.append((int(row[1]), int(row[2]), row[4:6]))

    # re-segment the flat IMU stream into per-keyframe spans, interpolating
    # nothing (sample times come straight from the files)
    w_body = gyro[:, 1:] @ PERM
    a_body = accel[:, 1:] @ PERM
    t_imu = gyro[:, 0]
    for i in range(n - 1):
        m = (t_imu >= times[i] - 1e-9) & (t_imu <= times[i + 1] + 1e-9)
        idx = np.flatnonzero(m)
        if len(idx) < 2:
            continue
        sim.imu_spans.append((w_body[idx], a_body[idx], t_imu[idx]))
    return sim
