"""The port's banded reduced solvers end to end against ba_tpu on identical
problems (f64, CPU, plain versions of the kernels).

`use_banded_solver` with cyclic reduction and with the scan: one GN
build's step, cost, gradient and Cauchy factor agree to 1e-9 relative,
three GN iterations keep the cost and step traces within 1e-8 (32 poses of
a fast trajectory, band width 8, chunks of 8: four chunks, so cyclic
reduction engages).  The dense fallback without a band.  One build of the
two reduced solvers ported after these, the matrix-free PCG and the dense
fleet solve (their own tests: test_torch_cg.py, test_torch_fleet.py).
`schur_on_band`, the grouped Schur form and the dogleg are in
test_torch_banded_drivers.py.
"""

import dataclasses

import jax
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import step as jstep
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_rel, banded_case, jax_problem,
                               to_torch, torch_config)

TOL = 1e-9


def solver_case(path, **cfg):
    """The 32-pose fast-trajectory case on `path` ("banded" or
    "schur_on_band")."""
    jp, jcfg, tp, tcfg = banded_case(32, speed=3.0, banded_chunk=8, **cfg)
    assert jcfg.band_width == 8
    assert tstep._reduced_path(tp, tcfg)[0] == path
    return jp, jcfg, tp, tcfg


def check_step_and_trajectory(jp, jcfg, tp, tcfg):
    """One build's step (1e-9) and three GN iterations (1e-8)."""
    want = jax.jit(jstep._build_and_solve, static_argnums=(1, 2))(
        jp, jcfg, True)
    got = tstep._build_and_solve(tp, tcfg, True)
    assert bool(got.step.ok) and bool(want.step.ok)
    for field in ("delta_p", "delta_l"):
        assert_rel(getattr(got.step, field), getattr(want.step, field), TOL,
                   field)
    for field in ("cost", "rhs_p", "rhs_l", "cauchy_alpha"):
        assert_rel(getattr(got, field), getattr(want, field), TOL, field)
    p_j, costs_j, dns_j = jstep.solve_fixed(jp, jcfg, True, 3)
    p_t, costs_t, dns_t = tstep.solve_fixed(tp, tcfg, True, 3)
    assert_rel(costs_t, costs_j, 1e-8, "costs")
    assert_rel(dns_t, dns_j, 1e-8, "delta norms")
    assert_rel(p_t.poses.t, p_j.poses.t, 1e-8, "poses.t")
    assert float(costs_t[-1]) < float(costs_t[0])


@pytest.mark.parametrize("bcr", [True, False], ids=["bcr", "scan"])
def test_banded_gn_step_and_trajectory_match(bcr):
    check_step_and_trajectory(*solver_case(
        "banded", banded_cyclic_reduction=bcr))


def test_banded_solver_falls_back_without_band():
    """use_banded_solver without a band width takes the dense path, as
    ba_tpu does (its tests/test_banded.py:234)."""
    jp, jcfg, _ = jax_problem(n_poses=10, n_lms=24)
    jcfg = dataclasses.replace(jcfg, use_banded_solver=True)
    jp = jprob.prepare_landmarks(jp, jcfg)
    tp, tcfg = to_torch(jp), torch_config(jcfg)
    assert tstep._reduced_path(tp, tcfg)[0] == "dense"
    _, costs_j, _ = jstep.solve_fixed(jp, jcfg, True, 2)
    _, costs_t, _ = tstep.solve_fixed(tp, tcfg, True, 2)
    assert bool(torch.isfinite(costs_t).all())
    assert_rel(costs_t, costs_j, 1e-8, "costs")


def _fused_fleet(n_poses=24):
    """Two windows of one scene (perturbation seeds 1 and 2) fused by
    `concat_problems`, with the fleet configuration: band width from the
    fused problem, `use_banded_solver`, `fleet_size` 2."""
    (w1, jcfg, _), (w2, _, _) = [
        jax_problem(n_poses=n_poses, n_lms=int(2.5 * n_poses), seed=s,
                    with_marg_prior=False) for s in (1, 2)]
    jf = jprob.concat_problems([w1, w2], jcfg)
    jcfg = dataclasses.replace(jcfg, band_width=jasm.band_width_of(jf),
                               use_banded_solver=True, fleet_size=2)
    jf = jprob.prepare_landmarks(jf, jcfg)
    return jf, jcfg, to_torch(jf), torch_config(jcfg)


@pytest.mark.parametrize("case,path", [("cg", "cg"),
                                       ("fleet", "fleet_dense")])
def test_cg_and_fleet_builds_match(case, path):
    """The two reduced solvers ported after the banded ones: the
    matrix-free PCG on a banded problem (`use_cg_solver` with the band set
    and the banded solver off) and the dense fleet solve of a fused fleet,
    one build against ba_tpu at 1e-9."""
    if case == "cg":
        jp, jcfg, _, _ = banded_case(24)
        jcfg = dataclasses.replace(jcfg, use_cg_solver=True,
                                   use_banded_solver=False)
        tp, tcfg = to_torch(jp), torch_config(jcfg)
    else:
        jp, jcfg, tp, tcfg = _fused_fleet()
    assert tstep._reduced_path(tp, tcfg)[0] == path
    want = jax.jit(jstep._build_and_solve, static_argnums=(1, 2))(
        jp, jcfg, True)
    got = tstep._build_and_solve(tp, tcfg, True)
    assert bool(got.step.ok) and bool(want.step.ok)
    for field in ("delta_p", "delta_l"):
        assert_rel(getattr(got.step, field), getattr(want.step, field), TOL,
                   field)
    for field in ("cost", "rhs_p", "rhs_l", "cauchy_alpha"):
        assert_rel(getattr(got, field), getattr(want, field), TOL, field)
