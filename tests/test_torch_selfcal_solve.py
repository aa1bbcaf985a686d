"""The self-calibrating `solve` of the port against ba_tpu's (f64, CPU) on
the <R,1,15,5,true> scenes of test_torch_selfcal.py: with `verbose` (the
host loop, one printed line per iteration) and the calibration marginals,
and with staged T_vs translation at 36 poses, where the unlock fires after
the second iteration and the third moves the translation too.  The
summaries, the final states and the marginals agree to 1e-8.
"""

import dataclasses

from ba_tpu.solver import step as jstep
from ba_tpu_torch.solver import step as tstep

from test_torch_common import assert_rel, to_torch, torch_config
from test_torch_selfcal import selfcal_problem


def _summaries_match(s_t, s_j, tol):
    assert s_t.iterations == s_j.iterations
    assert s_t.result == s_j.result
    assert s_t.tvs_translation_enabled == s_j.tvs_translation_enabled
    for name in ("initial_cost", "final_cost", "delta_norm",
                 "pre_solve_norm", "post_solve_norm", "proj_error",
                 "inertial_error"):
        assert_rel(getattr(s_t, name), getattr(s_j, name), tol, name)


def _states_match(p_t, p_j, tol):
    for name in ("params", "tvs_q", "tvs_t"):
        assert_rel(getattr(p_t.rig, name), getattr(p_j.rig, name), tol, name)
    for name in ("q", "t", "v", "b"):
        assert_rel(getattr(p_t.poses, name), getattr(p_j.poses, name), tol,
                   name)
    assert_rel(p_t.lms.x_w, p_j.lms.x_w, tol, "lms.x_w")


def test_solve_verbose_with_marginals_matches(capsys):
    jp, jcfg = selfcal_problem()
    jcfg = dataclasses.replace(jcfg, calculate_calibration_marginals=True)
    tcfg = torch_config(jcfg)
    p_j, s_j = jstep.solve(jp, jcfg, max_iter=6, use_imu=True, verbose=1)
    out_j = capsys.readouterr().out
    p_t, s_t = tstep.solve(to_torch(jp), tcfg, max_iter=6, use_imu=True,
                           verbose=1)
    out_t = capsys.readouterr().out
    assert out_t.count("iter ") == out_j.count("iter ") == s_j.iterations
    _summaries_match(s_t, s_j, 1e-8)
    _states_match(p_t, p_j, 1e-8)
    assert s_t.calibration_marginals.shape == (11, 11)
    assert_rel(s_t.calibration_marginals, s_j.calibration_marginals, 1e-8,
               "calibration marginals")
    assert s_t.final_cost < s_t.initial_cost


def test_solve_staged_tvs_translation_matches():
    jp, jcfg = selfcal_problem(n_poses=36, n_lms=90, staged=True,
                               frozen=False)
    tcfg = torch_config(jcfg)
    # the unlock fires after the second iteration; the third moves the
    # translation too
    p_j, s_j = jstep.solve(jp, jcfg, max_iter=3, use_imu=True)
    p_t, s_t = tstep.solve(to_torch(jp), tcfg, max_iter=3, use_imu=True)
    assert s_j.tvs_translation_enabled      # the unlock fired
    _summaries_match(s_t, s_j, 1e-8)
    _states_match(p_t, p_j, 1e-8)
