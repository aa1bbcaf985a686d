"""The port's `ViCalibrator` against ba_tpu's through all three stages on
the rotation-rich IMU capture of tests/test_calibrator.py (f64, CPU): the
same stage sequence, intrinsics, T_vs and biases to 1e-8 after each
`solve_once`, and the T_vs rotation pulled toward the truth."""

import jax.numpy as jnp
import numpy as np

from ba_tpu.core import lie as jlie

from test_calibrator import TRUE_CAM
from test_torch_calib import _imu_capture, check_stages


def test_solve_once_stages_match_imu():
    t = check_stages(_imu_capture(), TRUE_CAM.copy())
    err = np.linalg.norm(np.asarray(jlie.so3_log(jnp.asarray(t.tvs_q))))
    assert err < 0.3 * np.linalg.norm([0.06, -0.05, 0.04])
