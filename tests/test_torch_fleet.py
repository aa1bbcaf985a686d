"""The port's fused vehicle fleet against ba_tpu (f64, CPU, plain versions
of the kernels).

`concat_problems` of equal windows and of unequal ones (other pose,
landmark and IMU sample counts, so the IMU tables are padded) gives every
leaf of ba_tpu's fused problem, integers exactly and with the same dtypes,
floats to 1e-12, and raises where ba_tpu raises.  On a fleet of two
12-pose windows, one build's step, cost, gradient and Cauchy factor agree
to 1e-9 on the per-window dense solve (`solve_reduced_fleet_dense`, equal
windows) and on the banded solver with a fleet axis (an odd landmark
count, so F does not divide L), and three fused GN iterations keep the
cost and step traces within 1e-8.  Each case asserts the reduced path.

The odd fleet also has an odd projection row count: ba_tpu's per-window
segment sums (`seg_sum_blocks` with `fleet`) assume every window holds the
same number of rows when the row count divides by F, which windows of
different landmark counts break.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.io import simulate_vins as jsv
from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import step as jstep
from ba_tpu_torch.core import problem as tprob
from ba_tpu_torch.solver import step as tstep

from test_torch_common import assert_rel, to_torch, torch_config

JCFG = jprob.BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)


def _window(n_poses, n_lms, seed, imu_per_span=10):
    sim = jsv.simulate(n_poses=n_poses, n_lms=n_lms, seed=0,
                       imu_per_span=imu_per_span)
    return jsv.build_problem(sim, JCFG, perturb=0.01, seed=seed)[0]


@functools.lru_cache(maxsize=None)
def windows(kind):
    """JAX windows: "equal" (one scene, two perturbations, as
    `bench_fleet.py` builds them), "unequal" (8 and 12 poses, 6 and 10 IMU
    samples per span) or "odd" (12 poses each, 23 + 24 landmarks and
    194 + 197 projection rows)."""
    if kind == "equal":
        return (_window(12, 30, 1), _window(12, 30, 2))
    if kind == "unequal":
        return (_window(8, 20, 1, imu_per_span=6), _window(12, 31, 2))
    return (_window(12, 30, 1), _window(12, 31, 2))


def assert_same_tree(got, want, what="fused"):
    """Every leaf of a port tree against a JAX tree: same dtype, integers
    and booleans exactly, floats to 1e-12."""
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        name = f"{what}.{f.name}"
        if dataclasses.is_dataclass(w):
            assert_same_tree(g, w, name)
            continue
        w = np.asarray(w)
        assert g.cpu().numpy().dtype == w.dtype, (name, g.dtype, w.dtype)
        assert_rel(g, w, 1e-12, name)


@pytest.mark.parametrize("kind", ["equal", "unequal"])
def test_concat_problems_matches(kind):
    ws = windows(kind)
    want = jprob.concat_problems(list(ws), JCFG)
    got = tprob.concat_problems([to_torch(w) for w in ws],
                                torch_config(JCFG))
    assert got.poses.q.device.type == "cpu"
    if kind == "unequal":
        assert ws[0].imu.w.shape[1] != ws[1].imu.w.shape[1]
    assert_same_tree(got, want)


@pytest.mark.parametrize("fault", ["prior", "gravity"])
def test_concat_problems_raises_where_jax_raises(fault):
    ws = list(windows("equal"))
    if fault == "prior":
        ws[1] = dataclasses.replace(ws[1], marg=dataclasses.replace(
            ws[1].marg, active=jax.numpy.ones((), bool)))
        match = "marginalization"
    else:
        ws[1] = dataclasses.replace(ws[1], g_vec=ws[1].g_vec + 0.1)
        match = "gravity"
    with pytest.raises(ValueError, match=match):
        jprob.concat_problems(ws, JCFG)
    with pytest.raises(ValueError, match=match):
        tprob.concat_problems([to_torch(w) for w in ws], torch_config(JCFG))


def fleet_case(kind):
    """The fused fleet of `windows(kind)`, prepared, on both sides, with
    the fleet configuration of `bench_fleet.py --mode concat`."""
    jf = jprob.concat_problems(list(windows(kind)), JCFG)
    jcfg = dataclasses.replace(JCFG, band_width=jasm.band_width_of(jf),
                               use_banded_solver=True, fleet_size=2)
    jf = jprob.prepare_landmarks(jf, jcfg)
    return jf, jcfg, to_torch(jf), torch_config(jcfg)


@pytest.mark.parametrize("kind,path", [("equal", "fleet_dense"),
                                       ("odd", "banded")])
def test_fleet_build_and_solve_matches(kind, path):
    jp, jcfg, tp, tcfg = fleet_case(kind)
    L = tp.lms.x.shape[0]
    assert (L % 2 == 0) == (kind == "equal")
    assert tstep._reduced_path(tp, tcfg)[0] == path
    want = jax.jit(jstep._build_and_solve, static_argnums=(1, 2))(
        jp, jcfg, True)
    got = tstep._build_and_solve(tp, tcfg, True)
    assert bool(got.step.ok) and bool(want.step.ok)
    for field in ("delta_p", "delta_l"):
        assert_rel(getattr(got.step, field), getattr(want.step, field), 1e-9,
                   field)
    for field in ("cost", "rhs_p", "rhs_l", "cauchy_alpha"):
        assert_rel(getattr(got, field), getattr(want, field), 1e-9, field)


def test_fused_fleet_solve_fixed_traces_match():
    jp, jcfg, tp, tcfg = fleet_case("equal")
    assert tstep._reduced_path(tp, tcfg)[0] == "fleet_dense"
    p_j, costs_j, dns_j = jstep.solve_fixed(jp, jcfg, True, 3)
    p_t, costs_t, dns_t = tstep.solve_fixed(tp, tcfg, True, 3)
    assert_rel(costs_t, costs_j, 1e-8, "costs")
    assert_rel(dns_t, dns_j, 1e-8, "delta norms")
    assert_rel(p_t.poses.t, p_j.poses.t, 1e-8, "poses.t")
    assert_rel(p_t.lms.x, p_j.lms.x, 1e-8, "lms.x")
    assert float(costs_t[-1]) < float(costs_t[0])
    assert bool(torch.isfinite(costs_t).all())
