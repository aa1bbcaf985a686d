"""The port's sharded solves and fleets (`ba_tpu_torch/parallel/shard.py`)
on a world of two gloo ranks on the CPU, in f64, against ba_tpu's
single-device solves of the same problems (as ba_tpu's own
tests/test_sharding.py holds its shard_map routes), and the ranks against
each other.

One world runs every case of this module (the module's `world` fixture:
`torch_mesh_worker.run_world`, joined within 120 s), while ba_tpu's
references are computed in REF_PROCESSES spawned processes (each
reference is one trace of ~7-25 s) and `fleet_serve --mesh 2 --device
cpu` runs on a tiny fleet.  The problems are ba_tpu's, laid out by its
`partition_by_landmark` over two shards, the pose tables padded to a
multiple of two, carried to the ranks as numpy arrays:

  * A: simulate(8 poses, 32 landmarks), pose_dim 9, visual rows only, an
    active random dense marginalization prior: the row-sharded GN, the
    landmark-sharded dense GN and dogleg, the PCG GN and dogleg,
    `sharded_solve_fixed`, and `multihost` (each rank builds A itself
    from the seeds and keeps its rows);
  * B: simulate(16 poses, 40 landmarks, speed 3), no prior, band width
    from the problem: the banded solver;
  * C: B with an active random prior under `schur_on_band`: the
    distributed sliding window, also with the IMU rows and robust IMU
    weights (their global medians);
  * a fleet of four windows of simulate(8, 24) (`sharded_fleet_solve`)
    and four ring schedules of simulate(12, 40) (`sharded_ring_fleet`).

Each landmark-sharded case checks one build (delta_p, the ranks' delta_l
in landmark order, the cost, the Cauchy factor) at 1e-9, and every case
three iterations (costs, step norms, states) at 1e-8, against ba_tpu's
`solve_fixed` of the route's configuration: a debug callback in
`_build_and_solve` reports its first build, so that one trace gives both.
The fleets are held to ba_tpu's `solve_fleet` and `run_ring` per window
or stream at 1e-8, and bit for bit to the port's `solve_fleet` run in a
rank process (one thread, as every rank).  The replicated outputs must be
the same bits on both ranks.  `Mesh.single` holds each route against the
port's own single-card route at 1e-12, in this process.
"""

import contextlib
import dataclasses
import multiprocessing
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.io import simulate_vins as jsv
from ba_tpu.parallel.partition import partition_by_landmark
from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import fixedlag as jfl
from ba_tpu.solver import step as jstep
from ba_tpu_torch.parallel import shard
from ba_tpu_torch.parallel.mesh import Mesh
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_rel, jax_problem, to_torch,
                               torch_config, with_random_prior)
from torch_mesh_worker import flatten, run_world

REPO = Path(__file__).resolve().parents[1]
RANKS = 2
ITERS = 3
TOL_STEP = 1e-9
TOL_TRACE = 1e-8
WINDOWS = 4
RINGS, W, SLIDES, RING_ITERS = 4, 5, 4, 2
# processes computing ba_tpu's references beside the world, and the
# seconds they may take together
REF_PROCESSES = 3
REF_TIMEOUT_S = 300
# the JAX settings (tests/conftest.py's) the reference processes take
_JAX_SETTINGS = ("jax_platforms", "jax_enable_x64",
                 "jax_compilation_cache_dir",
                 "jax_persistent_cache_min_entry_size_bytes",
                 "jax_persistent_cache_min_compile_time_secs")


def _pad_pose_tables(jp, mult):
    """ba_tpu's tests/test_sharding.py:88: the pose-space tables padded
    with zero (invalid) rows to a multiple of `mult` (in numpy)."""
    def pad(a):
        a = np.asarray(a)
        m = (-a.shape[0]) % mult if a.ndim else 0
        if m:
            a = np.concatenate([a, np.zeros((m,) + a.shape[1:], a.dtype)])
        return jnp.asarray(a)

    return dataclasses.replace(jp, **{
        t: jax.tree_util.tree_map(pad, getattr(jp, t))
        for t in ("unary", "binary", "imu")})


_prepare = jax.jit(jprob.prepare_landmarks, static_argnums=1)


def _layout(jp, jcfg):
    jp = partition_by_landmark(jp, jcfg, RANKS)
    return _prepare(_pad_pose_tables(jp, RANKS), jcfg)


def _problems():
    """{name: (JAX problem, JAX config of its GN route)}."""
    jp, jcfg, _ = jax_problem(n_poses=8, n_lms=32, perturb=0.02)
    a = _layout(with_random_prior(jp, scale=0.05), jcfg)
    jp, jcfg_b, _ = jax_problem(n_poses=16, n_lms=40, with_marg_prior=False,
                                speed=3.0)
    jcfg_b = dataclasses.replace(jcfg_b, band_width=jasm.band_width_of(jp),
                                 use_banded_solver=True)
    assert 0 < jcfg_b.band_width < 16
    b = _layout(jp, jcfg_b)
    jp, _, _ = jax_problem(n_poses=16, n_lms=40, speed=3.0)
    jcfg_c = dataclasses.replace(jcfg_b, use_banded_solver=False,
                                 schur_on_band=True)
    c = _layout(with_random_prior(jp, scale=0.05), jcfg_c)
    return dict(A=(a, jcfg), B=(b, jcfg_b), C=(c, jcfg_c))


def _fleet():
    """Four windows of simulate(8 poses, 24 landmarks), perturbed with
    seeds 100 + v, prepared and stacked (ba_tpu's)."""
    cfg = jprob.BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    sim = jsv.simulate(n_poses=8, n_lms=24, seed=0)
    windows = [_prepare(jsv.build_problem(sim, cfg, perturb=0.01,
                                          seed=100 + v)[0], cfg)
               for v in range(WINDOWS)]
    return jprob.stack_problems(windows), cfg


def _rings():
    """Four ring schedules of simulate(12 poses, 40 landmarks), build
    seeds 3 + s, no prior, visual rows only at pose_dim 6 (ba_tpu's)."""
    cfg = jprob.BAConfig(pose_dim=6, lm_size=1, use_dogleg=False)
    sim = jsv.simulate(n_poses=12, n_lms=40, seed=2)
    scheds = []
    for s in range(RINGS):
        p, _, _ = jsv.build_problem(sim, cfg, perturb=0.01, seed=3 + s,
                                    with_marg_prior=False)
        scheds.append(jfl.build_ring_schedule(_prepare(p, cfg), cfg, W,
                                              SLIDES))
    return scheds, cfg


def _ring_arrays(scheds):
    out = {}
    for s, sc in enumerate(scheds):
        flatten(dict(inputs=sc.inputs, carry0=sc.carry0, rig=sc.rig,
                     g_vec=sc.g_vec), f"ring{s}", out)
        for k in ("W", "L_w", "n_slides"):
            out[f"ring{s}_{k}"] = np.asarray(getattr(sc, k))
    return out


_CG = dict(use_cg_solver=True, cg_max_iterations=400, cg_tolerance=1e-12)
_IMU = dict(use_robust_norm_for_inertial_residuals=True)
# name: (kind, problem, config changes, use_imu, the ba_tpu reference:
# `solve_fixed` of the problem under the same configuration)
CASES = {
    "rows_gn": ("rows", "A", {}, False, "A-gn"),
    "dense_gn": ("lm", "A", {}, False, "A-gn"),
    "dense_dogleg": ("lm", "A", dict(use_dogleg=True), False, "A-dogleg"),
    "cg_gn": ("lm", "A", _CG, False, "A-cg"),
    "cg_dogleg": ("lm", "A", dict(_CG, use_dogleg=True), False,
                  "A-cg-dogleg"),
    "banded_gn": ("lm", "B", {}, False, "B"),
    "banded_prior_gn": ("lm", "C", {}, False, "C"),
    "banded_prior_imu_gn": ("lm", "C", _IMU, True, "C-imu"),
    "solve_fixed": ("fixed", "A", {}, False, "A-gn"),
    "multihost": ("multihost", "A", {}, False, "A-gn"),
}


@contextlib.contextmanager
def _captured_builds():
    """ba_tpu's `_build_and_solve` reporting each build's step, cost and
    Cauchy factor to the host (a debug callback), so that one compiled
    solve gives both the build and the trace; the jit caches of the
    iterations are cleared around it."""
    builds = []
    orig = jstep._build_and_solve
    jitted = (jstep.gn_iteration, jstep.dogleg_iteration, jstep.solve_fixed)

    def report(*xs):
        builds.append([np.asarray(x) for x in xs])

    def build(problem, config, use_imu):
        out = orig(problem, config, use_imu)
        jax.debug.callback(report, out.step.delta_p, out.step.delta_l,
                           out.cost, out.cauchy_alpha, out.step.ok,
                           ordered=False)
        return out

    jstep._build_and_solve = build
    for f in jitted:
        f.clear_cache()
    try:
        yield builds
    finally:
        jstep._build_and_solve = orig
        for f in jitted:
            f.clear_cache()


def _init_reference_process(settings):
    for name, value in settings.items():
        jax.config.update(name, value)


def _reference(job):
    """One of ba_tpu's references, in a reference process: (name, value).
    A route's: (first build, final problem, costs, step norms) of
    `solve_fixed`; the fleet's: `solve_fleet`'s (problems, costs, step
    norms); the rings': each schedule's `run_ring` outputs."""
    name, args = job
    if name == "fleet":
        fleet, cfg = args
        p, costs, dns = jstep.solve_fleet(fleet, cfg, False, ITERS)
        return name, (jax.device_get(p), np.asarray(costs), np.asarray(dns))
    if name == "rings":
        scheds, cfg = args
        return name, [jax.tree_util.tree_map(
            np.asarray, jfl.run_ring(s, cfg, False, RING_ITERS)[1])
            for s in scheds]
    jp, cfg, use_imu = args
    with _captured_builds() as builds:
        p, costs, dns = jstep.solve_fixed(jp, cfg, use_imu, ITERS)
        value = (jax.device_get(p), np.asarray(costs), np.asarray(dns))
        jax.effects_barrier()
    return name, (builds[0],) + value


def _references(jobs):
    """{name: value} of every job, computed in REF_PROCESSES spawned
    processes (the longest first; every process is killed on a failure
    or after REF_TIMEOUT_S)."""
    settings = {k: getattr(jax.config, k) for k in _JAX_SETTINGS}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(REF_PROCESSES, _init_reference_process,
                  (settings,)) as pool:
        done = pool.map_async(_reference, jobs, chunksize=1)
        return dict(done.get(REF_TIMEOUT_S))


def _reference_jobs(problems, fleet, fleet_cfg, scheds, ring_cfg):
    """ba_tpu's references: each route's `solve_fixed`, the IMU route's
    (the longest) first, then the fleet's and the rings'."""
    routes = {}
    for kind, prob, changes, use_imu, ref in CASES.values():
        jp, jcfg = problems[prob]
        routes[ref] = (jp, dataclasses.replace(jcfg, **changes), use_imu)
    jobs = sorted(routes.items(), key=lambda kv: not kv[1][2])
    return jobs + [("fleet", (fleet, fleet_cfg)),
                   ("rings", (scheds, ring_cfg))]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    problems = _problems()
    fleet, fleet_cfg = _fleet()
    scheds, ring_cfg = _rings()
    cases, arrays = [], {}
    for name, (kind, prob, changes, use_imu, _) in CASES.items():
        jp, jcfg = problems[prob]
        cfg = torch_config(jcfg, **changes)
        cases.append(dict(name=name, kind=kind, use_imu=use_imu,
                          iters=ITERS, config=dataclasses.asdict(cfg),
                          poses=8, lms=32, perturb=0.02, prior_scale=0.05))
        if kind != "multihost":
            arrays[name] = flatten(jax.tree_util.tree_map(np.asarray, jp),
                                   "problem")
    cases += [dict(name="fleet", kind="fleet", use_imu=False, iters=ITERS,
                   config=dataclasses.asdict(torch_config(fleet_cfg))),
              dict(name="ring", kind="ring", use_imu=False, iters=RING_ITERS,
                   rings=RINGS,
                   config=dataclasses.asdict(torch_config(ring_cfg)))]
    arrays["fleet"] = flatten(jax.tree_util.tree_map(np.asarray, fleet),
                              "problem")
    arrays["ring"] = _ring_arrays(scheds)
    jobs = _reference_jobs(problems, fleet, fleet_cfg, scheds, ring_cfg)
    d = tmp_path_factory.mktemp("shard")
    with open(d / "fleet_serve.log", "w") as log:
        app = subprocess.Popen(
            [sys.executable, "-m", "ba_tpu_torch.apps.fleet_serve",
             "--vehicles", "2", "--poses", "6", "--lms", "20", "--iters",
             "2", "--mesh", "2", "--device", "cpu"], cwd=REPO,
            env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=log,
            stderr=subprocess.STDOUT)
    try:
        results, refs, _ = run_world(d, cases, arrays, RANKS,
                                     during=lambda: _references(jobs))
        app.wait(timeout=120)
    finally:
        if app.poll() is None:
            app.kill()
            app.wait()
    return results, refs, problems, (app.returncode,
                                     (d / "fleet_serve.log").read_text())


def _joined(outs, key):
    """A landmark-sharded output in global landmark order: the ranks'
    blocks one after another."""
    return np.concatenate([o[key] for o in outs])


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if c[0] == "lm"])
def test_sharded_build_matches_ba_tpu(world, name):
    """One build: delta_p, the ranks' delta_l in landmark order, the cost
    and (dogleg) the Cauchy factor, at 1e-9."""
    results, refs, _, _ = world
    outs = results[name]
    delta_p, delta_l, cost, alpha, ok = refs[CASES[name][4]][0]
    assert all(bool(o["ok"]) for o in outs) and bool(ok)
    assert_rel(outs[0]["delta_p"], delta_p, TOL_STEP, "delta_p")
    assert_rel(_joined(outs, "delta_l"), delta_l, TOL_STEP, "delta_l")
    assert_rel(outs[0]["cost"], cost, TOL_STEP, "cost")
    if "alpha" in outs[0]:
        assert_rel(outs[0]["alpha"], alpha, TOL_STEP, "alpha")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_iterations_match_ba_tpu(world, name):
    """Three iterations: costs and step norms at 1e-8, the states (the
    ranks' landmarks in landmark order) at 1e-8; `multihost`: the costs of
    the ranks that built the problem themselves and kept their rows."""
    results, refs, _, _ = world
    kind = CASES[name][0]
    outs = results[name]
    _, p_j, costs_j, dns_j = refs[CASES[name][4]]
    if kind in ("fixed", "multihost"):
        costs, dns = outs[0]["costs"], outs[0]["dns"]
    else:
        costs, dns = outs[0]["post_cost"], outs[0]["delta_norm"]
    assert_rel(costs, costs_j, TOL_TRACE, "costs")
    assert_rel(dns, dns_j, TOL_TRACE, "delta norms")
    assert costs[-1] < costs[0]
    if kind == "multihost":
        return
    for f in ("q", "t", "v", "b"):
        want = getattr(p_j.poses, f)
        assert_rel(outs[0][f"poses_{f}"], np.asarray(want), TOL_TRACE,
                   f"poses.{f}")
    lms = outs[0]["lms_x"] if kind == "rows" else _joined(outs, "lms_x")
    assert_rel(lms, np.asarray(p_j.lms.x), TOL_TRACE, "lms.x")


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_outputs_are_bit_identical(world, name):
    results = world[0]
    a, b = results[name]
    kind = CASES[name][0]
    keys = ["collectives"]
    if kind != "multihost":
        keys += ["poses_q", "poses_t", "poses_v", "poses_b"]
    if kind in ("fixed", "multihost"):
        keys += ["costs", "dns"]
    else:
        keys += ["pre_cost", "post_cost", "delta_norm", "accepted",
                 "trust_radius", "inner_trials"]
    if kind == "lm":
        keys += ["delta_p", "cost"] + (["alpha"] if "alpha" in a else [])
    if kind == "rows":
        keys += ["lms_x"]
    for k in keys:
        assert np.array_equal(a[k], b[k]), k
    # each landmark-sharded rank keeps its own chunk: its rows (padding
    # too) point inside it, in global numbering
    if kind == "lm":
        Lk = a["lms_x"].shape[0]
        assert a["proj_lm"].max() < Lk <= b["proj_lm"].min()


@pytest.mark.parametrize("name", ["rows_gn", "dense_gn", "dense_dogleg",
                                  "cg_gn", "banded_gn",
                                  "banded_prior_imu_gn"])
def test_single_rank_mesh_matches_single_card_route(world, name):
    """`Mesh.single` communicates nothing: the sharded route on it is the
    single-card route with its sums split the sharded way."""
    problems = world[2]
    kind, prob, changes, use_imu, _ = CASES[name]
    jp, jcfg = problems[prob]
    tp, cfg = to_torch(jp), torch_config(jcfg, **changes)
    mesh = Mesh.single("cpu")
    local = shard.shard_problem(tp, mesh, landmark_sharded=kind != "rows")
    trust = torch.full((), -1.0, dtype=torch.float64)
    if kind == "rows":
        got = shard.sharded_gn_iteration(local, cfg, use_imu, mesh)
    elif cfg.use_dogleg:
        got = shard.sharded_dogleg_iteration_lm(local, cfg, use_imu, mesh,
                                                trust)
    else:
        got = shard.sharded_gn_iteration_lm(local, cfg, use_imu, mesh)
    if cfg.use_dogleg:
        want = tstep.dogleg_iteration(local, cfg, use_imu, trust)
    else:
        want = tstep.gn_iteration(local, cfg, use_imu)
    for f in ("pre_cost", "post_cost", "delta_norm"):
        assert_rel(getattr(got, f), getattr(want, f), 1e-12, f)
    assert bool(got.accepted) == bool(want.accepted)
    assert_rel(got.problem.poses.t, want.problem.poses.t, 1e-12, "poses.t")
    assert_rel(got.problem.lms.x, want.problem.lms.x, 1e-12, "lms.x")


def test_sharded_fleet_matches_ba_tpu_solve_fleet(world):
    results, refs, _, _ = world
    p_j, costs_j, dns_j = refs["fleet"]
    outs = results["fleet"]
    costs = np.concatenate([o["costs"] for o in outs])
    assert_rel(costs, costs_j, TOL_TRACE, "costs")
    assert_rel(np.concatenate([o["dns"] for o in outs]), dns_j, TOL_TRACE,
               "delta norms")
    for f in ("q", "t", "v", "b"):
        assert_rel(np.concatenate([o[f"poses_{f}"] for o in outs]),
                   getattr(p_j.poses, f), TOL_TRACE, f"poses.{f}")
    assert_rel(np.concatenate([o["lms_x"] for o in outs]), p_j.lms.x,
               TOL_TRACE, "lms.x")
    assert (costs[:, -1] < costs[:, 0]).all()


def test_sharded_fleet_equals_solve_fleet_bit_for_bit(world):
    """Rank r's windows against the same windows of rank 0's
    `solve_fleet` of the whole fleet."""
    outs = world[0]["fleet"]
    n = WINDOWS // RANKS
    for r, o in enumerate(outs):
        mine = slice(r * n, (r + 1) * n)
        assert np.array_equal(o["costs"], outs[0]["all_costs"][mine])
        assert np.array_equal(o["dns"], outs[0]["all_dns"][mine])
        for k in ("poses_q", "poses_t", "poses_v", "poses_b", "lms_x"):
            assert np.array_equal(o[k], outs[0][f"all_{k}"][mine]), (r, k)


def test_sharded_ring_fleet_matches_ba_tpu_run_ring(world):
    """Each ring's per-slide cost and retired pose (q, t: a pose_dim-6
    state has no v or b) against ba_tpu's `run_ring` at 1e-8."""
    results, refs, _, _ = world
    outs = results["ring"]
    n = RINGS // RANKS
    for s, want in enumerate(refs["rings"]):
        got = outs[s // n]
        for key in ("cost", "q", "t"):
            assert_rel(got[f"outs_{key}"][s % n], want[key], TOL_TRACE,
                       f"ring {s} {key}")
        assert np.isfinite(got["outs_cost"]).all()


def test_fleet_serve_mesh_runs_on_the_cpu(world):
    rc, log = world[3]
    assert rc == 0, log[-3000:]
    line = [x for x in log.splitlines() if x.startswith("fleet of")]
    assert len(line) == 1, log[-3000:]
    assert "sharded over 2 ranks, gloo on cpu" in line[0]
    assert "keyframes/s" in line[0] and "ATE" in line[0]
