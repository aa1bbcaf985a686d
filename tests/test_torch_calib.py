"""The port's `ViCalibrator` against ba_tpu's (f64, CPU, plain versions of
the kernels) on the captures of tests/test_calibrator.py: the vision-only
capture of `_make_capture` (linear camera, pose_dim 6, the five
intrinsics) and the rotation-rich IMU capture of
`test_stage0_rotation_only_recovers_tvs_rotation`, which runs all three
stages (rotation-only IMU with the T_vs translation frozen, then full IMU,
then 15-dim states with biases).  `solve_once` takes the same stage
sequence and leaves the same intrinsics, T_vs and biases to 1e-8 (the IMU
capture in test_torch_calib_imu.py);
`write_camera_models` writes the same XML up to float formatting; the
background thread starts, solves and stops; kernel 1's plain version with
XYZ landmarks, the linear camera and the calibration columns matches
ba_tpu's to 1e-10.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import ba_tpu.calib as jcal
import ba_tpu.core.problem as jprob
from ba_tpu.core import lie as jlie
from ba_tpu.core.residuals import reprojection as jrp
import ba_tpu_torch.calib as tcal
from ba_tpu_torch.core.residuals import reprojection as trp

from test_calibrator import TRUE_CAM, _make_capture
from test_torch_common import assert_rel, to_torch, torch_config


def _vision_capture():
    """(target, frames [(q, t, obs, time)], imu [], tvs_q) with pose
    guesses off by rotations and shifts of 0.02."""
    target, frames = _make_capture()
    rng = np.random.default_rng(1)
    out = []
    for (q, t, obs, time) in frames:
        dq = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.02)))
        out.append((np.asarray(jlie.quat_mul(jnp.asarray(q),
                                             jnp.asarray(dq))),
                    t + rng.normal(size=3) * 0.02, obs, time))
    return target, out, [], None


def _imu_capture():
    """The spinning capture of tests/test_calibrator.py:123-199: 10 frames
    at 2.5 Hz, gyro and accelerometer at 50 Hz, T_vs rotation off by
    ~0.09 rad."""
    xs, ys = np.meshgrid(np.linspace(-0.4, 0.4, 5), np.linspace(-0.3, 0.3, 4))
    target = np.stack([xs.ravel(), ys.ravel(), np.zeros(20)], -1)
    pos = np.array([0.0, 0.0, -2.0])
    n_frames, dt_f = 10, 0.4

    def q_of(t):
        return np.asarray(jlie.quat_mul(
            jlie.so3_exp(jnp.asarray([0.0, 0.25 * np.sin(0.8 * t), 0.0])),
            jlie.so3_exp(jnp.asarray([0.2 * np.sin(1.1 * t), 0.0,
                                      0.15 * t]))))

    frames = []
    for i in range(n_frames):
        t = i * dt_f
        q = q_of(t)
        R = Rotation.from_quat([q[1], q[2], q[3], q[0]]).as_matrix()
        obs = []
        for pid, pw in enumerate(target):
            pc = R.T @ (pw - pos)
            if pc[2] < 0.1:
                continue
            obs.append((pid, np.array([TRUE_CAM[0] * pc[0] / pc[2]
                                       + TRUE_CAM[2],
                                       TRUE_CAM[1] * pc[1] / pc[2]
                                       + TRUE_CAM[3]])))
        frames.append((q, pos, obs, t))
    imu = []
    for t in np.arange(0.0, (n_frames - 1) * dt_f + 1e-9, 1.0 / 50.0):
        q0, q1 = q_of(t), q_of(t + 1e-4)
        w = np.asarray(jlie.so3_log(jlie.quat_mul(
            jlie.quat_conj(jnp.asarray(q0)), jnp.asarray(q1)))) / 1e-4
        R = Rotation.from_quat([q0[1], q0[2], q0[3], q0[0]]).as_matrix()
        imu.append((w, -R.T @ np.array([0.0, 0.0, -jlie.GRAVITY]), t))
    tvs_q = np.asarray(jlie.so3_exp(jnp.asarray([0.06, -0.05, 0.04])))
    return target, frames, imu, tvs_q


def _fill(cal, capture, cam):
    target, frames, imu, tvs_q = capture
    cal.add_camera(cam, 0)
    if tvs_q is not None:
        cal.tvs_q = tvs_q.copy()
    for (q, t, obs, time) in frames:
        f = cal.add_frame(q, t, time)
        for (pid, pix) in obs:
            cal.add_observation(f, pid, pix)
    for (w, a, t) in imu:
        cal.add_imu_measurements(w, a, t)
    return cal


def _pair(capture, cam):
    return (_fill(jcal.ViCalibrator(capture[0]), capture, cam),
            _fill(tcal.ViCalibrator(capture[0], use_f64=True, device="cpu"),
                  capture, cam))


def check_stages(capture, cam):
    """Three `solve_once` passes on both services: the same stages and
    results."""
    j, t = _pair(capture, cam)
    for stage in range(3):
        assert j.stage == t.stage == min(stage, jcal.STAGE_BIASES)
        mse_j = j.solve_once(max_iter=25)
        mse_t = t.solve_once(max_iter=25)
        assert t.stage == j.stage, (stage, t.stage, j.stage)
        np.testing.assert_allclose(mse_t, mse_j, rtol=1e-8, atol=1e-12)
        for name in ("cam_params", "tvs_q", "tvs_t", "biases"):
            np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                       rtol=0, atol=1e-8, err_msg=name)
    assert t.stage == tcal.STAGE_BIASES
    return t


def test_solve_once_stages_match_vision():
    t = check_stages(_vision_capture(),
                     TRUE_CAM + np.array([15.0, -12.0, 6.0, -5.0]))
    np.testing.assert_allclose(t.cam_params[:4], TRUE_CAM, atol=0.5)


@pytest.mark.parametrize("jac", [True, False])
def test_reprojection_xyz_linear_matches(jac):
    """Kernel 1's plain version with XYZ landmarks (lm_size 3), the linear
    camera and the 11 calibration columns, on the service's last-stage
    problem of the IMU capture, against ba_tpu's `reprojection.evaluate`
    to 1e-10."""
    capture = _imu_capture()
    j = _fill(jcal.ViCalibrator(capture[0]), capture, TRUE_CAM + 3.0)
    jp, jcfg, _, _ = j._build(*j._snapshot(), jcal.STAGE_BIASES)
    assert (jcfg.lm_size, jcfg.calib_dim) == (3, 11)
    jp = jprob.prepare_landmarks(jp, jcfg)
    want = jrp.evaluate(jp, jcfg, jac)
    got = trp.evaluate_plain(to_torch(jp), torch_config(jcfg), jac)
    for name in want._fields:
        assert_rel(getattr(got, name), getattr(want, name), 1e-10, name)


def _numbers(text):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", text)]


def test_write_camera_models_matches(tmp_path):
    j, t = _pair(_imu_capture(), TRUE_CAM.copy())
    j.solve_once(max_iter=10)
    t.solve_once(max_iter=10)
    jcal.write_camera_models(j, str(tmp_path / "j.xml"))
    tcal.write_camera_models(t, str(tmp_path / "t.xml"))
    a, b = (tmp_path / "t.xml").read_text(), (tmp_path / "j.xml").read_text()
    assert re.sub(r"-?\d+\.?\d*(?:e-?\d+)?", "#", a) == \
        re.sub(r"-?\d+\.?\d*(?:e-?\d+)?", "#", b)
    np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=1e-8,
                               atol=1e-10)


def test_background_thread_starts_and_stops():
    target, frames = _make_capture(n_frames=5)
    cal = _fill(tcal.ViCalibrator(target, use_f64=True, device="cpu"),
                (target, frames, [], None), TRUE_CAM + 5.0)
    cal.start()
    import time

    for _ in range(200):
        if np.isfinite(cal.mse) and cal.mse < 1e-4:
            break
        time.sleep(0.1)
    cal.stop()
    assert cal._thread is None
    assert np.isfinite(cal.mse) and cal.mse < 1e-3, cal.mse

