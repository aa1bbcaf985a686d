"""The port's last host modules against the JAX package's, on the CPU:
`native.NativeProblemBuilder` (C++, built with g++), the solver utility
`summary.landmark_outlier_ratio`, `utils.checkpoint` and `utils.timing`.

NativeProblemBuilder: the fills of tests/test_native.py (random states and
every residual family with padding to 4; a simulated scene) give the same
Problem as ba_tpu's pure-Python `ProblemBuilder` to 1e-12, and the scene
solves.  (ba_tpu's own native builder is not the reference here: its lazy
in-place build races under parallel test workers.)  landmark_outlier_ratio:
1e-12 against ba_tpu's on a scene with one landmark's observations
corrupted and on a noisy one.  Checkpoint: a round trip keeps every leaf
bit for bit, ba_tpu's checkpoint of the same Problem loads leaf for leaf
(and the port's into ba_tpu), a solve resumed from a checkpoint is
bit-identical to an unbroken one, and a wrong structure or shape raises
ba_tpu's errors.  Timing: spans record only while tracing is on, with
their calls, self and host-read seconds, counters on the host and the
device, `report` keeps and `reset` empties the store, `trace_to` writes a
Chrome trace.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.core import camera as jcam
from ba_tpu.io import simulate_vins as jsv
from ba_tpu.solver.summary import landmark_outlier_ratio as j_ratio
from ba_tpu.utils import checkpoint as jckpt
from ba_tpu_torch import native
from ba_tpu_torch.core.problem import prepare_landmarks
from ba_tpu_torch.solver import step as tstep
from ba_tpu_torch.solver.summary import landmark_outlier_ratio as t_ratio
from ba_tpu_torch.utils import checkpoint as tckpt
from ba_tpu_torch.utils import timing
from ba_tpu_torch.utils.tree import tree_map

from test_solver_reprojection import make_scene
from test_torch_common import (assert_tree_rel, jax_problem, to_torch,
                               torch_config)


def _fill_random(b, cfg):
    """tests/test_native.py:53-83's fill."""
    rng = np.random.default_rng(0)
    cam = b.add_camera([200.0, 200.0, 320.0, 240.0, 0.9], jcam.MODEL_FOV)
    ids = []
    for i in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        ids.append(b.add_pose(q, rng.normal(size=3), v=rng.normal(size=3),
                              active=i > 0, time=float(i)))
    lm = [b.add_landmark(rng.normal(size=3), ref_pose=0, ref_cam=cam)
          for _ in range(7)]
    for i in range(5):
        for j in range(7):
            b.add_projection_residual(rng.normal(size=2) * 100 + 300,
                                      ids[i], lm[j], cam)
    b.add_unary_constraint(ids[1], [1.0, 0, 0, 0], [0.0, 0, 0],
                           cov=np.eye(6) * 0.5)
    b.add_binary_constraint(ids[1], ids[2], [1.0, 0, 0, 0], [1.0, 0, 0],
                            cov=np.eye(6) * 2.0)
    n = 6
    b.add_imu_residual(ids[1], ids[2], rng.normal(size=(n, 3)),
                       rng.normal(size=(n, 3)), np.linspace(1.0, 2.0, n))
    return dict(pad_multiple=4)


def _fill_scene(b, cfg):
    """tests/test_native.py:101-125's fill: 8 poses of a simulated
    sequence, perturbed from seed 1."""
    sim = jsv.simulate(n_poses=8, n_lms=40, seed=11)
    cam = b.add_camera(sim.cam_params, jcam.MODEL_FOV, tvs_q=sim.tvs_q,
                       tvs_t=sim.tvs_t)
    rng = np.random.default_rng(1)
    ids = []
    for i in range(8):
        t = sim.t_wv[i] + (rng.normal(size=3) * 0.02 if i >= 2 else 0)
        ids.append(b.add_pose(sim.q_wv[i], t, active=i >= 2,
                              time=float(sim.pose_times[i])))
    first_seen = {}
    for (i, j, z) in sim.obs:
        if i < 8 and (j not in first_seen or i < first_seen[j]):
            first_seen[j] = i
    lm_ids = {j: b.add_landmark(sim.lms_w[j], ref_pose=ids[r], ref_cam=cam)
              for j, r in first_seen.items()}
    for (i, j, z) in sim.obs:
        if i < 8:
            b.add_projection_residual(z, ids[i], lm_ids[j], cam)
    return {}


@pytest.mark.parametrize("fill", [_fill_random, _fill_scene],
                         ids=["random", "scene"])
def test_native_builder_matches_python_builder(fill):
    jcfg = jprob.BAConfig(pose_dim=9 if fill is _fill_random else 6,
                          lm_size=1, use_dogleg=False)
    jb = jprob.ProblemBuilder(jcfg)
    kw = fill(jb, jcfg)
    jp = jb.build(**kw)
    cfg = torch_config(jcfg)
    tb = native.NativeProblemBuilder(cfg)
    fill(tb, cfg)
    tp = tb.build(device="cpu", **kw)
    tb.close()
    tb.close()                                    # idempotent
    assert_tree_rel(tp, jp, 1e-12)
    if fill is _fill_scene:
        _, summary = tstep.solve(tp, cfg, max_iter=15, use_imu=False)
        assert summary.final_cost < 1e-4, summary


def test_native_builder_needs_cuda_or_cpu(monkeypatch):
    cfg = torch_config(jprob.BAConfig(pose_dim=6))
    b = native.NativeProblemBuilder(cfg)
    b.add_pose([1.0, 0, 0, 0], [0.0, 0, 0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b.build()
    assert b.build(device="cpu").poses.q.device.type == "cpu"


def _corrupted(noise, corrupt):
    """make_scene's problem with pixel noise, prepared; with `corrupt`
    every observation of landmark 3 moved by 500 px
    (tests/test_diagnostics.py:50).  Noise keeps the clean rows' errors
    away from rounding: without it they are ~1e-20 px^2 and which of them
    lie above the median-based Huber scale is rounding."""
    jp, jcfg = make_scene(n_poses=8, n_lms=30, perturb=0.0, noise=noise)
    jp = jprob.prepare_landmarks(jp, jcfg)
    if corrupt:
        z = np.asarray(jp.proj.z).copy()
        z[(np.asarray(jp.proj.lm) == 3) & np.asarray(jp.proj.valid)] += 500.0
        jp = dataclasses.replace(jp, proj=dataclasses.replace(
            jp.proj, z=jnp.asarray(z)))
    return jp, jcfg


@pytest.mark.parametrize("noise,corrupt", [(1.0, True), (2.0, False)],
                         ids=["one_corrupted", "noisy"])
def test_landmark_outlier_ratio_matches(noise, corrupt):
    jp, jcfg = _corrupted(noise, corrupt)
    want = np.asarray(j_ratio(jp, jcfg))
    got = t_ratio(to_torch(jp), torch_config(jcfg))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert ((want > 0) & (want < 1)).any()
    if corrupt:
        assert want[3] > 0.9


def _problem():
    jp, jcfg, _ = jax_problem(n_poses=10, n_lms=40)
    return jp, jcfg, to_torch(jp), torch_config(jcfg)


def _leaves(tree):
    out = []
    tree_map(lambda a: out.append(a) or a, tree)
    return out


def _bit_identical(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_round_trip(tmp_path):
    _, _, tp, _ = _problem()
    path = str(tmp_path / "p.npz")
    tckpt.save(path, tp, extra={"iteration": 3, "note": "x"})
    assert len(_leaves(tp)) == 76
    assert _bit_identical(tckpt.load(path, tp), tp)
    assert tckpt.extra(path) == {"iteration": 3, "note": "x"}


def test_checkpoint_loads_ba_tpus_leaf_for_leaf(tmp_path):
    jp, _, tp, _ = _problem()
    jckpt.save(str(tmp_path / "j.npz"), jp, extra={"k": 1})
    back = tckpt.load(str(tmp_path / "j.npz"), tp)
    assert_tree_rel(back, jp, 0.0)
    assert tckpt.extra(str(tmp_path / "j.npz")) == {"k": 1}
    tckpt.save(str(tmp_path / "t.npz"), tp)
    jback = jckpt.load(str(tmp_path / "t.npz"), jp)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_resumed_solve_is_bit_identical(tmp_path):
    _, _, tp, cfg = _problem()
    p = prepare_landmarks(tp, cfg)
    whole = tstep.solve_fixed(p, cfg, True, 2)[0]
    half = tstep.solve_fixed(p, cfg, True, 1)[0]
    tckpt.save(str(tmp_path / "c.npz"), half)
    resumed = tstep.solve_fixed(tckpt.load(str(tmp_path / "c.npz"), half),
                                cfg, True, 1)[0]
    assert _bit_identical(resumed, whole)
    assert not _bit_identical(half, whole)


def test_checkpoint_structure_and_shape_errors(tmp_path):
    jp, _, tp, _ = _problem()
    path = str(tmp_path / "c.npz")
    tckpt.save(path, tp)
    with pytest.raises(ValueError, match="checkpoint structure mismatch: "
                       "76 saved leaves vs 8 in the target structure"):
        tckpt.load(path, tp.poses)
    other = to_torch(jax_problem(n_poses=12, n_lms=48)[0])
    with pytest.raises(ValueError, match=r"checkpoint shape mismatch at "
                       r"leaf 0: \(10, 4\) vs \(12, 4\)"):
        tckpt.load(path, other)
    # ba_tpu's own messages on the same mistakes
    with pytest.raises(ValueError, match="76 saved leaves vs 8"):
        jckpt.load(path, jp.poses)


def test_timing_spans_and_report():
    timing.reset()                                    # start empty
    x = torch.ones(3)
    with timing.span("b"):                            # off: nothing kept
        pass
    timing.count("n", 5)
    assert timing.summary() == dict(spans={}, counters={})
    with timing.enable():
        for _ in range(2):
            with timing.span("a"):
                x = x * 2
                with timing.span("host_read"):
                    pass
        timing.count("n", 2)
        timing.count("n", 3)
        timing.count("d", torch.tensor(4))
        timing.count("d", torch.tensor(1))
    s = timing.summary()
    a, r = s["spans"]["a"], s["spans"]["host_read"]
    assert (a["calls"], r["calls"]) == (2, 2)
    assert a["stream_s"] is None                      # CPU: no events
    assert a["self_s"] == pytest.approx(a["host_s"] - r["host_s"])
    assert a["wait_s"] == pytest.approx(r["host_s"])
    assert s["counters"] == {"n": 5, "d": 5}
    text = timing.report()
    assert "a " in text and "counter n" in text and "       2" in text
    assert timing.report() == text                    # reading keeps them
    timing.reset()
    assert timing.summary() == dict(spans={}, counters={})


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with timing.trace_to(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
