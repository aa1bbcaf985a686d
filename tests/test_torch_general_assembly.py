"""The port's general assembly path (band_width == 0) against ba_tpu.

`assemble` on the general path (one grouped sum over a general
`AssemblyPlan`, `_pair_system` scatters, `expand_contribution`) against
ba_tpu's family-by-family general path, with and without IMU, with padded
tables, and with an active marginalization prior: every Assembly field to
1e-9 relative (the same sums in another order).  `expand_contribution` at
pose widths 6, 9 and 15, exactly.  And the repair: `step.solve` on a
problem whose band covers the whole window, which the banded-only port
refused, against `ba_tpu.solver.step.solve` to 1e-8 (roundoff amplified
by a few solves).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import step as jstep
from ba_tpu_torch.core import problem as tprob
from ba_tpu_torch.solver import assemble as tasm
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_rel, jax_problem, to_torch,
                               torch_config)

TOL = 1e-9

_j_imu_eval = jax.jit(jstep._imu_eval, static_argnums=(1, 2, 3))
_j_assemble = jax.jit(lambda p, cfg, ie: jasm.assemble(p, cfg, imu_eval=ie),
                      static_argnums=1)


def _general_case(pad_multiple, marg_active):
    jp, jcfg, _ = jax_problem(pad_multiple=pad_multiple)
    jp = jprob.prepare_landmarks(jp, jcfg)
    if marg_active:
        rng = np.random.default_rng(3)
        n = jp.marg.H.shape[0]
        A = rng.standard_normal((n, n)) * 0.1
        jp = dataclasses.replace(jp, marg=dataclasses.replace(
            jp.marg, H=jnp.asarray(A @ A.T),
            g=jnp.asarray(rng.standard_normal(n)),
            lin_t=jp.marg.lin_t + 0.01, active=jnp.ones((), bool)))
    assert jcfg.band_width == 0
    return jp, jcfg, to_torch(jp), torch_config(jcfg)


@pytest.mark.parametrize("use_imu,pad_multiple,marg_active", [
    (True, 1, False), (False, 3, False), (True, 1, True)])
def test_general_assemble_matches_ba_tpu(use_imu, pad_multiple, marg_active):
    jp, jcfg, tp, tcfg = _general_case(pad_multiple, marg_active)
    jie = _j_imu_eval(jp, jcfg, use_imu, True)
    tie = tstep._imu_eval(tp, tcfg, use_imu, True)
    want = _j_assemble(jp, jcfg, jie)
    plan = tasm.assembly_plan(tp, tcfg)
    assert plan.band_width == 0
    got = tasm.assemble(tp, tcfg, imu_eval=tie, plan=plan)
    for name in want._fields:
        assert_rel(getattr(got, name), getattr(want, name), TOL, name)


def test_general_plan_covers_a_band_wider_than_the_window():
    """band_width > P takes the general path, as in ba_tpu."""
    jp, jcfg, tp, tcfg = _general_case(1, False)
    P = tp.poses.q.shape[0]
    wide = dataclasses.replace(tcfg, band_width=P + 1)
    assert tasm.plan_width(tp, wide) == 0
    a = tasm.assemble(tp, wide)
    b = tasm.assemble(tp, tcfg)
    assert_rel(a.S, b.S.numpy(), 0.0, "S")


@pytest.mark.parametrize("pose_dim", [6, 9, 15])
def test_expand_contribution_matches_ba_tpu(pose_dim):
    rng = np.random.default_rng(pose_dim)
    P, K, L, lm = 5, 2, 7, 1
    n_c = P * 6 + K
    parts = dict(U=rng.standard_normal((n_c, n_c)),
                 rhs_p=rng.standard_normal(n_c),
                 W=rng.standard_normal((n_c, L * lm)),
                 V=rng.standard_normal((L, lm, lm)),
                 rhs_l=rng.standard_normal(L * lm),
                 cost=np.float64(rng.standard_normal()))
    want = jasm.expand_contribution(
        jasm.Contribution(**{k: jnp.asarray(v) for k, v in parts.items()}),
        P, pose_dim, K)
    got = tasm.expand_contribution(
        tasm.Contribution(**{k: torch.as_tensor(v)
                             for k, v in parts.items()}), P, pose_dim, K)
    for name in want._fields:
        assert_rel(getattr(got, name), getattr(want, name), 0.0, name)


def test_solve_when_the_band_covers_the_window():
    """A 12-pose problem: its band spans the window, so `solve` leaves
    band_width at 0 and takes the general path (the port raised here)."""
    jp, jcfg, _ = jax_problem()
    jcfg = dataclasses.replace(jcfg, use_dogleg=True)
    tcfg = torch_config(jcfg)
    assert jstep._auto_band_width(jp, jcfg).band_width == 0
    tp = to_torch(jp)
    assert tstep._auto_band_width(tp, tcfg).band_width == 0
    p_j, s_j = jstep.solve(jp, jcfg, max_iter=10)
    p_t, s_t = tstep.solve(tp, tcfg, max_iter=10)
    assert (s_t.iterations, s_t.result, s_t.inner_iterations) == (
        s_j.iterations, s_j.result, s_j.inner_iterations)
    for name in ("initial_cost", "final_cost", "delta_norm",
                 "pre_solve_norm", "post_solve_norm", "proj_error",
                 "inertial_error"):
        assert_rel(getattr(s_t, name), getattr(s_j, name), 1e-8, name)
    assert s_t.final_cost < s_t.initial_cost
    for name in ("q", "t", "v"):
        assert_rel(getattr(p_t.poses, name), getattr(p_j.poses, name),
                   1e-8, name)
    assert_rel(p_t.lms.x_w, p_j.lms.x_w, 1e-8, "lms.x_w")

