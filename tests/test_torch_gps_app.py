"""The port's GPS + IMU pose-graph smoother (`ba_tpu_torch/apps/
unary_binary_imu_test.py`) against the JAX package's app
(`apps/unary_binary_imu_test.py`), f64 on the CPU, where the port runs the
plain versions of its kernels.

Parsing: the port's native parser, its Python parser and ba_tpu's parsers
give the same records.  Building: the same Problem leaves at 1e-12 (the
same IMU spans through the two packages' interpolation buffers).  Batch
`solve(max_iter=25, gn_damping=0.2)`: the poses at 1e-8 and the same
iterations.  `run_streaming` with W = 6 on a 16-fix log: every retired
pose at 1e-8.  The app's `main` runs both modes on the CPU and raises
without CUDA when no device is given.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apps import unary_binary_imu_test as japp  # noqa: E402
from ba_tpu.solver import step as jstep  # noqa: E402
from ba_tpu_torch import native  # noqa: E402
from ba_tpu_torch.apps import unary_binary_imu_test as tapp  # noqa: E402

from test_torch_common import assert_rel, assert_tree_rel  # noqa: E402

# the solve traces: the same f64 steps, ordered differently
TOL_SOLVE = 1e-8


def _log(tmp_path, n_gps, fmt="ref", noise=0.2):
    path = tmp_path / f"log_{fmt}_{n_gps}.txt"
    japp.generate_log(str(path), n_gps=n_gps, noise_gps=noise, fmt=fmt)
    return str(path)


def _same_records(a, b, what):
    imu_a, gps_a, gu_a = a
    imu_b, gps_b, gu_b = b
    np.testing.assert_array_equal(imu_a, imu_b, err_msg=what)
    np.testing.assert_allclose(np.asarray(gps_a), np.asarray(gps_b),
                               rtol=1e-15, atol=0, err_msg=what)
    assert len(gu_a) == len(gu_b) == len(gps_a), what
    for (qa, ta), (qb, tb) in zip(gu_a, gu_b):
        np.testing.assert_allclose(qa, qb, rtol=1e-12, atol=1e-15,
                                   err_msg=what)
        np.testing.assert_allclose(ta, tb, rtol=1e-12, atol=1e-15,
                                   err_msg=what)


@pytest.mark.parametrize("fmt", ["ref", "csv"])
def test_parsers_agree(fmt, tmp_path):
    """The port's native and Python parsers and ba_tpu's app parser give
    the same IMU rows, re-based fixes and dead-reckoned guesses; the app
    says which parser ran."""
    path = _log(tmp_path, 12, fmt)
    py = tapp.parse_log_py(path)
    nat = native.parse_log(path, tapp.MAX_POSES)
    *app_rec, parser = tapp.parse_log(path)
    assert parser == "native"
    _same_records(nat, py, "native vs python")
    _same_records(tuple(app_rec), nat, "app vs native")
    _same_records(japp.parse_log_py(path), py, "ba_tpu python vs python")
    _same_records(japp.parse_log(path), nat, "ba_tpu app vs native")


def _built(path):
    """(JAX problem and config, port problem on the CPU and config) of
    one log, both f64."""
    imu, gps, gu = japp.parse_log(path)
    jp, jcfg = japp.build_problem_from_records(imu, gps, gu)
    tp, tcfg = tapp.build_problem_from_records(imu, gps, gu, device="cpu")
    return jp, jcfg, tp, tcfg


def test_build_matches(tmp_path):
    """Every Problem leaf at 1e-12, the configuration field by field (the
    band width of a chain of consecutive poses: 2)."""
    jp, jcfg, tp, tcfg = _built(_log(tmp_path, 12))
    assert tp.poses.t.dtype == torch.float64
    assert_tree_rel(tp, jp, 1e-12)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.band_width == 2 and tcfg.lm_size == 0


def test_batch_solve_matches(tmp_path):
    """`solve(max_iter=25, gn_damping=0.2, use_imu=True)` in f64: the
    poses (q, t, v, b) at 1e-8, the same iterations and result."""
    jp, jcfg, tp, tcfg = _built(_log(tmp_path, 12))
    jsol, jsum = jstep.solve(jp, jcfg, max_iter=25, gn_damping=0.2,
                             use_imu=True)
    tsol, tsum = tapp.solve_batch(tp, tcfg)
    assert tsum.iterations == jsum.iterations
    assert tsum.result == jsum.result and tsum.is_good
    assert tsum.final_cost < tsum.initial_cost
    for f in ("q", "t", "v", "b"):
        assert_rel(getattr(tsol.poses, f), getattr(jsol.poses, f),
                   TOL_SOLVE, f"poses.{f}")
    assert abs(tsum.final_cost - jsum.final_cost) <= TOL_SOLVE * max(
        1.0, jsum.final_cost)


def test_streaming_matches(tmp_path):
    """`run_streaming` with W = 6 on a 16-fix log (11 slides of 6 GN
    iterations, each marginalizing the departing pose): every retired
    pose's state and cost against ba_tpu's at 1e-8, and the written
    trajectories alike."""
    path = _log(tmp_path, 16)
    imu, gps, gu = japp.parse_log(path)
    jouts = jax.device_get(japp.run_streaming(
        imu, gps, gu, W=6, out=str(tmp_path / "j.csv")))
    touts, ring = tapp.run_streaming(imu, gps, gu, 6,
                                     out=str(tmp_path / "t.csv"),
                                     device="cpu")
    assert ring.device.type == "cpu"
    assert len(touts) == len(jouts) == len(gps) - 6 + 1
    for k, (t, j) in enumerate(zip(touts, jouts)):
        assert t["pose"] == j["pose"] == k
        for f in ("q", "t", "v", "b", "cost"):
            assert_rel(t[f], np.asarray(j[f]), TOL_SOLVE, f"slide {k} {f}")
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t.csv", delimiter=","),
                               np.loadtxt(tmp_path / "j.csv", delimiter=","),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("mode", ["batch", "stream"])
def test_app_needs_cuda_or_cpu(mode, tmp_path, monkeypatch, capsys):
    """The app raises without CUDA by default and runs with --device cpu
    (an 8-fix log; the stream with W = 4), naming its parser and device."""
    path = _log(tmp_path, 8)
    args = [path, "--out", str(tmp_path / "traj.csv")]
    if mode == "stream":
        args += ["--stream", "4"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.main(args)
    assert tapp.main(args + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "native parser" in out and "on cpu" in out
    traj = np.loadtxt(tmp_path / "traj.csv", delimiter=",")
    assert traj.shape == (8, 4) and np.isfinite(traj).all()
