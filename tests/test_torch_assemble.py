"""The port's banded assembly against ba_tpu on identical problems.

`assemble` -> `_assemble_banded` -> `finish` (S, rhs_sc, U, W, V, rhs_l,
cost), the reduced solve, the trial cost, and the pieces it is built
from: `seg_sum_blocks` (the plain version of kernel 2, with out-of-range
ids), `band_to_dense` and `band_width_of`.  Sums are ordered differently
on the two sides, so S, rhs and the step agree to 1e-9 relative; the
segment sums of random values to 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import linear as jlin
from ba_tpu.solver import step as jstep
from ba_tpu_torch.core import problem as tprob
from ba_tpu_torch.solver import assemble as tasm
from ba_tpu_torch.solver import linear as tlin
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_rel, jax_problem, to_torch,
                               torch_config)

TOL = 1e-9

# jitted JAX references: eager JAX runs the IMU scan op by op (seconds)
_j_imu_eval = jax.jit(jstep._imu_eval, static_argnums=(1, 2, 3))
_j_cost = jax.jit(jstep._cost, static_argnums=(1, 2))


@pytest.mark.parametrize("nseg", [5, 40, 600])
def test_seg_sum_blocks_drops_out_of_range_ids(nseg):
    """Against the JAX one-hot form (nseg <= 512) and its scatter form."""
    rng = np.random.default_rng(nseg)
    vals = rng.standard_normal((900, 6, 6))
    ids = rng.integers(-4, nseg + 4, 900).astype(np.int32)
    want = jasm.seg_sum_blocks(jnp.asarray(vals), jnp.asarray(ids), nseg)
    got = tasm.seg_sum_blocks(torch.as_tensor(vals), torch.as_tensor(ids),
                              nseg)
    assert_rel(got, want, 1e-12, "seg_sum_blocks")


def test_band_to_dense_and_band_width_match():
    rng = np.random.default_rng(0)
    band = rng.standard_normal((7, 3, 4, 4))
    band[:, 0] = band[:, 0] + np.swapaxes(band[:, 0], 1, 2)
    assert_rel(tasm.band_to_dense(torch.as_tensor(band)),
               jasm.band_to_dense(jnp.asarray(band)), 1e-14, "band_to_dense")
    for pad in (1, 3):
        jp, _, _ = jax_problem(n_poses=24, n_lms=60, pad_multiple=pad)
        assert tasm.band_width_of(to_torch(jp)) == jasm.band_width_of(jp)


def _case(n_poses, pad_multiple, marg_active):
    """Prepared problems on both sides with band_width from the problem;
    `marg_active` turns on a random dense prior (exercises the prior's
    contribution; the flagship carries an inactive one)."""
    jp, jcfg, _ = jax_problem(n_poses=n_poses, n_lms=4 * n_poses,
                              pad_multiple=pad_multiple)
    jcfg = dataclasses.replace(jcfg, band_width=jasm.band_width_of(jp))
    jp = jprob.prepare_landmarks(jp, jcfg)
    if marg_active:
        rng = np.random.default_rng(1)
        n = jp.marg.H.shape[0]
        A = rng.standard_normal((n, n)) * 0.1
        marg = dataclasses.replace(
            jp.marg, H=jnp.asarray(A @ A.T), g=jnp.asarray(
                rng.standard_normal(n)), lin_t=jp.marg.lin_t + 0.01,
            active=jnp.ones((), bool))
        jp = dataclasses.replace(jp, marg=marg)
    return jp, jcfg, to_torch(jp), torch_config(jcfg)


@pytest.mark.parametrize("n_poses,pad_multiple,marg_active",
                         [(12, 1, False), (12, 3, False), (24, 1, True)])
def test_banded_assembly_and_step_match(n_poses, pad_multiple, marg_active):
    jp, jcfg, tp, tcfg = _case(n_poses, pad_multiple, marg_active)
    assert tcfg.band_width <= tp.poses.q.shape[0]
    jie = _j_imu_eval(jp, jcfg, True, True)
    tie = tstep._imu_eval(tp, tcfg, True, True)
    want = jax.jit(lambda p, ie: jasm.assemble(p, jcfg, imu_eval=ie))(
        jp, jie)
    got = tasm.assemble(tp, tcfg, imu_eval=tie)
    for name in want._fields:
        assert_rel(getattr(got, name), getattr(want, name), TOL, name)

    jstep_ = jax.jit(jlin.solve_reduced)(want)
    tstep_ = tlin.solve_reduced(got)
    assert bool(tstep_.ok) and bool(jstep_.ok)
    assert_rel(tstep_.delta_p, jstep_.delta_p, TOL, "delta_p")
    assert_rel(tstep_.delta_l, jstep_.delta_l, TOL, "delta_l")
    assert_rel(tstep._cauchy_factor(got), jstep._cauchy_factor(want), TOL,
               "cauchy alpha")

    # the trial cost at the stepped state, with the build's frozen
    # weights and IMU covariance
    jc = jstep.apply_update(jp, jcfg, jstep_.delta_p, jstep_.delta_l)
    tc = tstep.apply_update(tp, tcfg, tstep_.delta_p, tstep_.delta_l)
    assert_rel(tstep._cost(tc, tcfg, True, got.proj_w, tie.c9),
               _j_cost(jc, jcfg, True, want.proj_w, jie.c9), TOL,
               "trial cost")


def test_general_assembly_path_raises():
    jp, jcfg, _ = jax_problem()
    tp = tprob.prepare_landmarks(to_torch(jp), torch_config(jcfg))
    with pytest.raises(NotImplementedError, match="general assembly"):
        tasm.assemble(tp, torch_config(jcfg, band_width=0))


def test_failed_factorization_gives_zero_pose_step():
    """cholesky_ex's info replaces cho_factor's NaN test: an indefinite S
    reports ok=False and a zero pose step instead of raising."""
    jp, jcfg, tp, tcfg = _case(12, 1, False)
    asm = tasm.assemble(tp, tcfg, imu_eval=tstep._imu_eval(tp, tcfg, True,
                                                            True))
    bad = asm._replace(S=asm.S - 2.0 * torch.diag(torch.diagonal(asm.S)))
    out = tlin.solve_reduced(bad)
    assert not bool(out.ok)
    assert float(out.delta_p.abs().max()) == 0.0
