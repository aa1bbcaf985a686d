"""The port's CSV I/O (`ba_tpu_torch/io/csvio.py`), CSV VINS app
(`ba_tpu_torch/apps/vins_csv.py`) and kernel check CLI
(`ba_tpu_torch/apps/math_test.py`) against the JAX package's
(`ba_tpu/io/csvio.py`, `apps/vins_csv.py`), f64 on the CPU.

CSV: both packages write byte-identical files from the same sequence, read
any sequence to the same values (1e-12), and the Euler helpers agree to
1e-12; a round trip returns the sequence to the files' 12 decimals (1e-9,
as tests/test_csvio.py).  Triangulation: the port unprojects every
landmark's two rays in one batch, the JAX app one pixel at a time; on this
16-pose sequence the two agree to 2.4e-12 m (measured), the rounding of
the rotation matrices (scipy's `as_matrix` there, the closed form here),
so 1e-10 relative.  The 3-iteration f64 GN solve on 16 poses and 48
landmarks starts both packages from the same (the port's) landmarks and
agrees to 1e-8 in the poses, with the same iterations.  Both apps' `main`
run on the CPU and raise without CUDA when no device is given.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apps import vins_csv as japp  # noqa: E402
from ba_tpu.core.problem import BAConfig as JConfig  # noqa: E402
from ba_tpu.io import csvio as jcsv  # noqa: E402
from ba_tpu.io import simulate_vins as jsv  # noqa: E402
from ba_tpu.solver import step as jstep  # noqa: E402
from ba_tpu.solver.assemble import band_width_of  # noqa: E402
from ba_tpu_torch.apps import math_test as tmath  # noqa: E402
from ba_tpu_torch.apps import vins_csv as tapp  # noqa: E402
from ba_tpu_torch.io import csvio as tcsv  # noqa: E402
from ba_tpu_torch.io import simulate_vins as tsv  # noqa: E402

from test_torch_common import assert_rel  # noqa: E402

FILES = ("points.csv", "accel.csv", "gyro.csv", "poses.csv",
         "timestamps.csv")


def _same_sim(a, b, tol, what):
    for f in ("pose_times", "q_wv", "t_wv", "v_w", "lms_w", "cam_params",
              "tvs_q", "tvs_t"):
        assert_rel(getattr(a, f), getattr(b, f), tol, f"{what} {f}")
    assert [(i, j) for i, j, _ in a.obs] == [(i, j) for i, j, _ in b.obs]
    assert_rel(np.array([z for _, _, z in a.obs]),
               np.array([z for _, _, z in b.obs]), tol, f"{what} obs")
    assert len(a.imu_spans) == len(b.imu_spans)
    for sa, sb in zip(a.imu_spans, b.imu_spans):
        for x, y in zip(sa, sb):
            assert_rel(x, y, tol, f"{what} imu")


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """A 16-pose, 48-landmark sequence (the app's seed 3) written by the
    JAX package."""
    d = tmp_path_factory.mktemp("seq")
    jcsv.write_csv(jsv.simulate(n_poses=16, n_lms=48, seed=3), str(d))
    return d


def test_csv_write_is_byte_identical_and_reads_agree(tmp_path):
    sim = tsv.simulate(n_poses=10, n_lms=30, seed=0)
    jsim = jsv.simulate(n_poses=10, n_lms=30, seed=0)
    tcsv.write_csv(sim, str(tmp_path / "t"))
    jcsv.write_csv(jsim, str(tmp_path / "j"))
    for f in FILES:
        assert (tmp_path / "t" / f).read_bytes() \
            == (tmp_path / "j" / f).read_bytes(), f
    _same_sim(tcsv.read_csv(str(tmp_path / "j")),
              jcsv.read_csv(str(tmp_path / "j")), 1e-12, "read")


def test_csv_round_trip(tmp_path):
    sim = tsv.simulate(n_poses=10, n_lms=30, seed=1)
    tcsv.write_csv(sim, str(tmp_path))
    back = tcsv.read_csv(str(tmp_path))
    assert isinstance(back, tsv.SimData)
    assert back.lms_w.shape == (30, 3) and not back.lms_w.any()
    np.testing.assert_allclose(back.pose_times, sim.pose_times, atol=1e-9)
    np.testing.assert_allclose(back.t_wv, sim.t_wv, atol=1e-9)
    for qa, qb in zip(back.q_wv, sim.q_wv):
        np.testing.assert_allclose(qa * np.sign(qa @ qb), qb, atol=1e-9)
    for (ia, ja, za), (ib, jb, zb) in zip(back.obs, sim.obs):
        assert (ia, ja) == (ib, jb)
        np.testing.assert_allclose(za, zb, atol=1e-9)
    assert len(back.imu_spans) == len(sim.imu_spans)
    for (wa, aa, ta), (wb, ab, tb) in zip(back.imu_spans, sim.imu_spans):
        np.testing.assert_allclose(ta, tb, atol=1e-9)
        np.testing.assert_allclose(wa, wb, atol=1e-9)
        np.testing.assert_allclose(aa, ab, atol=1e-9)


def test_euler_helpers_match():
    rng = np.random.default_rng(0)
    for r, p, q in rng.uniform(-1.4, 1.4, size=(20, 3)):
        R = tcsv.euler_zyx_to_matrix(r, p, q)
        assert_rel(R, jcsv.euler_zyx_to_matrix(r, p, q), 1e-12, "matrix")
        assert_rel(np.array(tcsv.matrix_to_euler_zyx(R)),
                   np.array(jcsv.matrix_to_euler_zyx(R)), 1e-12, "euler")
        assert_rel(np.array(tcsv.matrix_to_euler_zyx(R)),
                   np.array([r, p, q]), 1e-12, "inverse")


def test_triangulation_matches(seq):
    jsim = jcsv.read_csv(str(seq))
    n_j = japp._triangulate(jsim)
    tsim, n_t, gt = tapp.read_sequence(str(seq))
    assert n_t == n_j > 30 and len(tsim.obs) == len(jsim.obs)
    assert [(i, j) for i, j, _ in tsim.obs] == \
        [(i, j) for i, j, _ in jsim.obs]
    assert_rel(tsim.lms_w, jsim.lms_w, 1e-10, "triangulated landmarks")
    assert_rel(tsim.v_w, np.gradient(jsim.t_wv, jsim.pose_times, axis=0),
               1e-12, "velocities")
    np.testing.assert_array_equal(gt, jsim.t_wv)


def test_vins_csv_solve_matches(seq):
    """3 GN iterations in f64 from the same landmarks (the port's
    triangulation), the app's configuration and perturbation (seed 11)."""
    tsim, _, gt = tapp.read_sequence(str(seq))
    res = tapp.run(tsim, gt, perturb=0.02, max_iter=3, device="cpu",
                   f64=True)
    cfg = JConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    jp, _, _ = jsv.build_problem(tsim, cfg, perturb=0.02, seed=11)
    cfg = dataclasses.replace(cfg, band_width=band_width_of(jp))
    jq, js = jstep.solve(jp, cfg, max_iter=3, use_imu=True)
    assert (res.summary.iterations, res.summary.result) == \
        (js.iterations, js.result)
    assert_rel(res.problem.poses.t, np.asarray(jq.poses.t), 1e-8, "t")
    assert_rel(res.problem.poses.q, np.asarray(jq.poses.q), 1e-8, "q")
    assert_rel(res.problem.poses.v, np.asarray(jq.poses.v), 1e-8, "v")
    assert res.summary.final_cost < res.summary.initial_cost
    ate = jsv.ate(None, np.asarray(jq.poses.t)[:16], None, gt)
    assert abs(res.ate - ate) <= 1e-8


def test_vins_csv_main_needs_cuda_or_cpu(tmp_path, monkeypatch, capsys):
    args = [str(tmp_path / "seq"), "--generate", "--poses", "8", "--lms",
            "24", "--max-iter", "2", "--out", str(tmp_path / "traj.csv")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.main(args)
    assert tapp.main(args + ["--device", "cpu", "--f64"]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out and "ATE" in out
    rows = np.loadtxt(tmp_path / "traj.csv", delimiter=",")
    assert rows.shape == (8, 8)


def test_math_test_passes_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmath.main([])
    assert tmath.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ALL PASS" in out and out.count("[PASS]") == 6
