"""The port's banded solvers on the other paths against ba_tpu (f64, CPU,
plain versions of the kernels): `schur_on_band` with an active
marginalization prior (one build's step to 1e-9, three GN iterations to
1e-8), one GN iteration through the grouped Schur form (forced in both
packages), and one dogleg `solve` on the banded solver (the same
accept/reject path, costs and states to 1e-8)."""

import jax
import pytest

from ba_tpu.solver import banded as jband
from ba_tpu.solver import step as jstep
from ba_tpu_torch.solver import banded as tband
from ba_tpu_torch.solver import step as tstep

from test_torch_banded_solve import check_step_and_trajectory, solver_case
from test_torch_common import (assert_rel, banded_case, to_torch,
                               with_random_prior)

TOL = 1e-9


def test_schur_on_band_with_marg_prior_matches():
    jp, jcfg, _, tcfg = solver_case("schur_on_band", with_marg_prior=True,
                                    use_banded_solver=False,
                                    schur_on_band=True)
    jp = with_random_prior(jp, scale=0.05)
    check_step_and_trajectory(jp, jcfg, to_torch(jp), tcfg)


def test_grouped_gn_iteration_matches(monkeypatch):
    """ba_tpu's jit cache does not key on the threshold: cleared around
    the call."""
    jp, jcfg, tp, tcfg = banded_case(24)
    monkeypatch.setattr(jband, "_GROUPED_SP_MIN", 0)
    monkeypatch.setattr(tband, "_GROUPED_SP_MIN", 0)
    assert tband.grouped_schur(tp, tcfg)
    jstep.gn_iteration.clear_cache()
    try:
        want = jstep.gn_iteration(jp, jcfg, True)
    finally:
        jstep.gn_iteration.clear_cache()
    got = tstep.gn_iteration(tp, tcfg, True)
    assert bool(got.accepted) and bool(got.solver_ok)
    for name in ("pre_cost", "post_cost", "delta_norm", "solver_ok"):
        assert_rel(getattr(got, name), getattr(want, name), TOL, name)
    assert_rel(got.problem.poses.t, want.problem.poses.t, TOL, "poses.t")


def test_banded_dogleg_solve_matches():
    jp, jcfg, tp, tcfg = banded_case(24, use_dogleg=True)
    p_j, s_j = jstep.solve(jp, jcfg, max_iter=5)
    p_t, s_t = tstep.solve(tp, tcfg, max_iter=5)
    assert (s_t.iterations, s_t.result, s_t.inner_iterations) == (
        s_j.iterations, s_j.result, s_j.inner_iterations)
    for name in ("initial_cost", "final_cost", "delta_norm"):
        assert_rel(getattr(s_t, name), getattr(s_j, name), 1e-8, name)
    assert_rel(p_t.poses.t, p_j.poses.t, 1e-8, "poses.t")
    assert s_t.final_cost < s_t.initial_cost
