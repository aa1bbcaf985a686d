"""Visual-inertial calibration service (background-thread solver).

Port of `ba_tpu/calib.py`.  A capture thread adds frames, target
observations and IMU samples; a background thread repeatedly rebuilds and
solves a self-calibration problem (camera intrinsics, camera-from-vehicle
extrinsics T_vs and IMU biases) with staged activation: T_vs rotation only,
then its translation, then the biases (15-dim states).  The target's
corners are known 3D points, so the landmarks are fixed XYZ states.

The problem lives on `device` (the card unless the caller passes
device="cpu"), in f64 with `use_f64` and f32 otherwise.
"""

from __future__ import annotations

import logging
import threading
import time
import xml.sax.saxutils as sx
from dataclasses import dataclass, field

import numpy as np

from . import resolve_device
from .core import camera as cam_mod
from .core.problem import BAConfig, ProblemBuilder
from .solver import step as step_mod

STAGE_ROTATION = 0      # T_vs rotation only (translation frozen at guess)
STAGE_TRANSLATION = 1   # + T_vs translation
STAGE_BIASES = 2        # + IMU biases (15-dim states)

log = logging.getLogger(__name__)


@dataclass
class _Frame:
    time: float
    q: np.ndarray
    t: np.ndarray
    obs: list = field(default_factory=list)   # (point_id, pixel)


class ViCalibrator:
    """Thread-safe accumulate + background solve."""

    def __init__(self, target_points: np.ndarray, use_f64: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dtype = np.float64 if use_f64 else np.float32
        self.target = np.asarray(target_points, np.float64)  # (Npts, 3)
        self.frames: list[_Frame] = []
        self.imu: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.cam_params = None
        self.cam_model = cam_mod.MODEL_LINEAR
        self.tvs_q = np.array([1.0, 0, 0, 0])
        self.tvs_t = np.zeros(3)
        self.biases = np.zeros(6)
        self.stage = STAGE_ROTATION
        self.mse = float("inf")
        self._lock = threading.Lock()
        self._thread = None
        self._run = False

    # -- accumulation (capture thread) -----------------------------------
    def add_camera(self, params, model=cam_mod.MODEL_LINEAR):
        with self._lock:
            self.cam_params = np.asarray(params, np.float64)
            self.cam_model = model

    def add_frame(self, q_wv, t_wv, time: float) -> int:
        with self._lock:
            self.frames.append(_Frame(time, np.asarray(q_wv, np.float64),
                                      np.asarray(t_wv, np.float64)))
            return len(self.frames) - 1

    def add_observation(self, frame: int, point_id: int, pixel):
        with self._lock:
            self.frames[frame].obs.append(
                (int(point_id), np.asarray(pixel, np.float64)))

    def add_imu_measurements(self, w, a, time: float):
        with self._lock:
            self.imu.append((float(time), np.asarray(w, np.float64),
                             np.asarray(a, np.float64)))

    # -- solving ----------------------------------------------------------
    def _snapshot(self):
        with self._lock:
            frames = [(f.time, f.q.copy(), f.t.copy(), list(f.obs))
                      for f in self.frames]
            return frames, list(self.imu)

    def _build(self, frames, imu, stage):
        # Without IMU terms T_vs is a pure 6-dof gauge, so the extrinsic
        # enters only with inertial residuals.  Stage 0 switches off their
        # translation and velocity rows and holds the T_vs translation: the
        # gyro pins the vehicle orientation, so the extrinsic rotation
        # converges first.
        use_imu = len(imu) > 2
        rotation_only = use_imu and stage == STAGE_ROTATION
        pose_dim = 15 if (use_imu and stage >= STAGE_BIASES) else \
            (9 if use_imu else 6)
        cfg = BAConfig(pose_dim=pose_dim, lm_size=3, calib_size=5,
                       do_tvs=use_imu, use_dogleg=True,
                       imu_rotation_only=rotation_only,
                       tvs_translation_staging=rotation_only,
                       tvs_translation_active=not rotation_only,
                       enable_auto_regularization=False,
                       error_change_threshold=1e-6,
                       param_change_threshold=1e-8)
        b = ProblemBuilder(cfg, dtype=self.dtype)
        cam = b.add_camera(self.cam_params, self.cam_model,
                           tvs_q=self.tvs_q, tvs_t=self.tvs_t)
        lm_ids = [b.add_landmark(p, ref_pose=0, ref_cam=cam, active=False)
                  for p in self.target]
        ids = [b.add_pose(q, t, b=self.biases.copy(), active=True, time=tm)
               for (tm, q, t, obs) in frames]
        for fi, (tm, q, t, obs) in enumerate(frames):
            for (pid, z) in obs:
                b.add_projection_residual(z, ids[fi], lm_ids[pid], cam)
        if use_imu:
            imu_arr = np.array([[t, *w, *a] for (t, w, a) in imu])
            for fi in range(len(frames) - 1):
                t0, t1 = frames[fi][0], frames[fi + 1][0]
                seg = imu_arr[(imu_arr[:, 0] >= t0) & (imu_arr[:, 0] <= t1)]
                if len(seg) >= 2:
                    b.add_imu_residual(ids[fi], ids[fi + 1], seg[:, 1:4],
                                       seg[:, 4:7], seg[:, 0])
        return b.build(device=self.device), cfg, use_imu, ids

    def solve_once(self, max_iter: int = 15) -> float:
        """One build + solve pass; returns the mean squared reprojection
        error (final cost over the number of projection residuals)."""
        frames, imu = self._snapshot()
        if not frames or self.cam_params is None:
            return float("inf")
        problem, cfg, use_imu, ids = self._build(frames, imu, self.stage)
        n_res = sum(len(f[3]) for f in frames)
        if n_res < 8:
            return float("inf")
        solved, summary = step_mod.solve(problem, cfg, max_iter=max_iter,
                                         use_imu=use_imu)
        with self._lock:
            self.cam_params = solved.rig.params[
                0, : len(self.cam_params)].double().cpu().numpy()
            if cfg.do_tvs:
                self.tvs_q = solved.rig.tvs_q[0].double().cpu().numpy()
                self.tvs_t = solved.rig.tvs_t[0].double().cpu().numpy()
            if use_imu:
                self.biases = solved.poses.b[ids[-1]].double().cpu().numpy()
            self.mse = summary.final_cost / max(n_res, 1)
            # staged unlock: advance once the current stage has converged
            if summary.is_good and self.stage < STAGE_BIASES:
                self.stage += 1
        return self.mse

    # -- background thread ------------------------------------------------
    def start(self):
        self._run = True
        self._thread = threading.Thread(target=self._solve_loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._run = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _solve_loop(self):
        failures = 0
        while self._run:
            try:
                self.solve_once()
                failures = 0
            except Exception:  # keep the service alive on transient errors
                # but log every failure and back off progressively, so a
                # persistent fault cannot spin the core
                failures += 1
                log.exception("calibration solve failed (%d consecutive)",
                              failures)
                time.sleep(min(0.1 * failures, 2.0))


# calibu-style model-type names for the XML rig export
_MODEL_XML_NAMES = {
    cam_mod.MODEL_LINEAR: "calibu_fu_fv_u0_v0",
    cam_mod.MODEL_FOV: "calibu_fu_fv_u0_v0_w",
    cam_mod.MODEL_POLY3: "calibu_fu_fv_u0_v0_k1_k2_k3",
    cam_mod.MODEL_EQUIDISTANT: "calibu_fu_fv_u0_v0_kb4",
}


def write_camera_models(calibrator: ViCalibrator, filename: str,
                        width: int = 640, height: int = 480) -> None:
    """Export the calibrated rig as a calibu-style XML file: one <camera>
    with its parameter vector, and the camera-from-vehicle pose <T_cv> as a
    quaternion and a translation."""
    with calibrator._lock:
        params = np.asarray(calibrator.cam_params, np.float64)
        model = calibrator.cam_model
        tvs_q = np.asarray(calibrator.tvs_q, np.float64)
        tvs_t = np.asarray(calibrator.tvs_t, np.float64)

    n_par = {cam_mod.MODEL_LINEAR: 4, cam_mod.MODEL_FOV: 5,
             cam_mod.MODEL_POLY3: 7, cam_mod.MODEL_EQUIDISTANT: 8}[model]
    par = "; ".join(f"{v:.12g}" for v in params[:n_par])
    # T_cv = T_vs^-1 (the rig stores vehicle-from-sensor)
    w, x, y, z = tvs_q
    q_inv = np.array([w, -x, -y, -z])
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    t_cv = -R.T @ tvs_t
    qs = "; ".join(f"{v:.12g}" for v in q_inv)
    ts = "; ".join(f"{v:.12g}" for v in t_cv)
    with open(filename, "w") as f:
        f.write('<rig>\n')
        f.write('  <camera>\n')
        f.write(f'    <camera_model name="" index="0" serialno="0" '
                f'type="{sx.escape(_MODEL_XML_NAMES[model])}" '
                f'version="8">\n')
        f.write(f'      <width> {width} </width>\n')
        f.write(f'      <height> {height} </height>\n')
        f.write(f'      <params> [ {par} ]</params>\n')
        f.write('    </camera_model>\n')
        f.write(f'    <pose> [ {qs}; {ts} ] </pose>\n')
        f.write('  </camera>\n')
        f.write('</rig>\n')
