"""The port's native host code (`ba_tpu_torch/native/`): the interpolation
buffer and the log parser, the cases of tests/test_native.py on the port's
copy, and its build: several processes building into one fresh directory
at once each load a working library (the build runs under a file lock and
moves a finished library into place)."""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from ba_tpu_torch import native
from ba_tpu_torch.apps import unary_binary_imu_test as app

REPO = Path(__file__).resolve().parents[1]


def test_interpolation_buffer_basic():
    ib = native.InterpolationBuffer(6)
    for i in range(10):
        ib.add(float(i), np.full(6, float(i)))
    assert len(ib) == 10
    assert ib.has(5.0) and not ib.has(11.0)
    np.testing.assert_allclose(ib.get(3.0), 3.0)
    np.testing.assert_allclose(ib.get(3.5), 3.5)  # linear interpolation
    np.testing.assert_allclose(ib.get(-1.0), 0.0)  # clamped
    np.testing.assert_allclose(ib.get(99.0), 9.0)
    ib.close()
    ib.close()                                     # idempotent


def test_interpolation_buffer_get_range():
    ib = native.InterpolationBuffer(2)
    for i in range(20):
        ib.add(0.1 * i, [i, -i])
    times, values = ib.get_range(0.25, 0.85)
    # boundary samples interpolated, interior samples exact
    np.testing.assert_allclose(times[0], 0.25)
    np.testing.assert_allclose(times[-1], 0.85)
    np.testing.assert_allclose(values[0, 0], 2.5)
    np.testing.assert_allclose(values[-1, 0], 8.5)
    assert np.all(np.diff(times) > 0)
    np.testing.assert_allclose(values[1:-1, 0], np.arange(3, 9))


def test_interpolation_buffer_out_of_order():
    ib = native.InterpolationBuffer(1)
    ib.add(0.0, [0.0])
    ib.add(2.0, [2.0])
    ib.add(1.0, [1.0])  # out-of-order insert
    np.testing.assert_allclose(ib.get(1.5), 1.5)


@pytest.mark.parametrize("fmt", ["ref", "csv"])
def test_native_log_parser_matches_python(fmt, tmp_path):
    """Native parse and dead reckoning == the app's pure-Python parser on
    a synthetic reference-format log (ODO/UTM/IMU) and on the CSV
    alternate: the IMU rows, the re-based fixes and the guesses."""
    path = tmp_path / f"log_{fmt}.txt"
    app.generate_log(str(path), n_gps=12, fmt=fmt)
    imu_n, gps_n, gu_n = native.parse_log(str(path), app.MAX_POSES)
    imu_p, gps_p, gu_p = app.parse_log_py(str(path))
    np.testing.assert_allclose(imu_n, imu_p, rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(gps_n), np.asarray(gps_p),
                               rtol=1e-15, atol=0)
    assert len(gu_n) == len(gu_p) == 12
    for (qn, tn), (qp, tp) in zip(gu_n, gu_p):
        np.testing.assert_allclose(qn, qp, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(tn, tp, rtol=1e-12, atol=1e-15)


def test_native_log_parser_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_log(str(tmp_path / "no_such_log.txt"))


_WORKER = """
import sys, time
sys.path.insert(0, {repo!r})
from ba_tpu_torch import native
while time.time() < {start}:
    time.sleep(0.001)
ib = native.InterpolationBuffer(2, build_dir={d!r})
for i in range(20):
    ib.add(0.1 * i, [i, -i])
t, v = ib.get_range(0.25, 0.85)
assert abs(v[0, 0] - 2.5) < 1e-12 and abs(v[-1, 0] - 8.5) < 1e-12
print("ok", native.build({d!r}).name)
"""


def test_concurrent_builds_into_one_directory(tmp_path):
    """Eight processes released at the same instant each build the
    library into one fresh directory and use it: every one loads a
    working library, one library file is left and no temporary file."""
    d = tmp_path / "build"
    code = _WORKER.format(repo=str(REPO), start=time.time() + 2.0, d=str(d))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(8)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("ok"), (out, err)
    names = {out.split()[1] for out, _ in outs}
    assert len(names) == 1
    files = sorted(f.name for f in d.iterdir() if f.name != ".lock")
    assert files == sorted(names), files
