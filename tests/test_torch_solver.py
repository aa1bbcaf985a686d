"""The slice as a whole: the port's GN iteration, the fixed-iteration GN
solve and the default dogleg `solve`, against ba_tpu on identical
problems (f64, CPU, plain versions of both kernels).

One iteration agrees to 1e-9 relative; five GN iterations keep the cost
and step-norm traces within 1e-8, and the dogleg solve takes the same
accept/reject path (iterations, status) with the same costs and states to
1e-8 — differences are roundoff amplified by a few solves.
"""

import dataclasses

import pytest

import ba_tpu.core.problem as jprob
from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import step as jstep
from ba_tpu_torch.core import problem as tprob
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_rel, assert_tree_rel, jax_problem,
                               to_torch, torch_config)


def _case(use_dogleg):
    jp, jcfg, _ = jax_problem()
    jcfg = dataclasses.replace(jcfg, use_dogleg=use_dogleg,
                               band_width=jasm.band_width_of(jp))
    return jp, jcfg, to_torch(jp), torch_config(jcfg)


def test_gn_iteration_matches():
    jp, jcfg, tp, tcfg = _case(False)
    jp = jprob.prepare_landmarks(jp, jcfg)
    tp = tprob.prepare_landmarks(tp, tcfg)
    want = jstep.gn_iteration(jp, jcfg, True)
    got = tstep.gn_iteration(tp, tcfg, True)
    for name in ("pre_cost", "post_cost", "delta_norm", "accepted",
                 "solver_ok", "pre_solve_norm", "post_solve_norm",
                 "inner_trials"):
        assert_rel(getattr(got, name), getattr(want, name), 1e-9, name)
    assert bool(got.accepted)
    assert_tree_rel(got.problem, want.problem, 1e-9)


def test_solve_fixed_gn_traces_match():
    jp, jcfg, tp, tcfg = _case(False)
    jp = jprob.prepare_landmarks(jp, jcfg)
    tp = tprob.prepare_landmarks(tp, tcfg)
    p_j, costs_j, dns_j = jstep.solve_fixed(jp, jcfg, True, 5)
    p_t, costs_t, dns_t = tstep.solve_fixed(tp, tcfg, True, 5)
    assert_rel(costs_t, costs_j, 1e-8, "costs")
    assert_rel(dns_t, dns_j, 1e-8, "delta norms")
    assert float(costs_t[-1]) < float(costs_t[0])
    assert_rel(p_t.poses.t, p_j.poses.t, 1e-8, "poses.t")
    assert_rel(p_t.lms.x, p_j.lms.x, 1e-8, "lms.x")


def test_solve_default_dogleg_matches():
    jp, jcfg, tp, tcfg = _case(True)
    p_j, s_j = jstep.solve(jp, jcfg, max_iter=10)
    p_t, s_t = tstep.solve(tp, tcfg, max_iter=10)
    assert s_t.iterations == s_j.iterations
    assert s_t.result == s_j.result
    assert s_t.inner_iterations == s_j.inner_iterations
    for name in ("initial_cost", "final_cost", "delta_norm",
                 "pre_solve_norm", "post_solve_norm", "proj_error",
                 "inertial_error", "unary_error", "binary_error"):
        assert_rel(getattr(s_t, name), getattr(s_j, name), 1e-8, name)
    for name in ("num_proj_residuals", "num_imu_residuals",
                 "num_cond_proj_residuals", "num_cond_imu_residuals"):
        assert getattr(s_t, name) == getattr(s_j, name), name
    assert s_t.final_cost < s_t.initial_cost
    for name in ("q", "t", "v"):
        assert_rel(getattr(p_t.poses, name), getattr(p_j.poses, name), 1e-8,
                   name)
    assert_rel(p_t.lms.x, p_j.lms.x, 1e-8, "lms.x")
    assert_rel(p_t.lms.x_w, p_j.lms.x_w, 1e-8, "lms.x_w")


@pytest.mark.parametrize("option", ["verbose", "use_cg_solver",
                                    "calculate_calibration_marginals"])
def test_unported_solve_options_raise(option):
    _, _, tp, tcfg = _case(True)
    kw = {}
    if option == "verbose":
        kw["verbose"] = 1
    else:
        tcfg = dataclasses.replace(tcfg, **{option: True})
    with pytest.raises(NotImplementedError):
        tstep.solve(tp, tcfg, max_iter=2, **kw)


def test_solve_auto_band_width_matches_jax():
    """band_width unset: `solve` fills it from the problem as ba_tpu does
    (24 poses: the band is narrower than the window)."""
    jp, jcfg, _ = jax_problem(n_poses=24, n_lms=60)
    jcfg = dataclasses.replace(jcfg, use_dogleg=True)
    tcfg = torch_config(jcfg)
    assert jstep._auto_band_width(jp, jcfg).band_width > 0
    assert (tstep._auto_band_width(to_torch(jp), tcfg).band_width
            == jstep._auto_band_width(jp, jcfg).band_width)
