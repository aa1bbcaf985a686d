"""The port's block system (`solver/cg.py`) against ba_tpu on identical
problems (f64, CPU, plain versions of the kernels).

Every leaf of `assemble_blocks`' BlockSystem and the marginalization
curvature, with and without the preconditioner, with and without IMU and
with an active marginalization prior; the landmark back-substitution and
the dogleg's Cauchy factor; and the products U x, W z and W^T x against
the dense U and W of ba_tpu's assembly.  The same sums in another order:
1e-9 relative to max(1, max |ba_tpu|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import cg as jcg
from ba_tpu.solver import step as jstep
from ba_tpu_torch.core import problem as tprob
from ba_tpu_torch.solver import cg as tcg
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_rel, jax_problem, to_torch,
                               torch_config)

TOL = 1e-9
_j_imu_eval = jax.jit(jstep._imu_eval, static_argnums=(1, 2, 3))


def _case(marg_active=False, mask=True, n_poses=16):
    """Prepared problems on both sides (band width from the problem); one
    pose has masked dims; `marg_active` turns on a random dense prior."""
    jp, jcfg, _ = jax_problem(n_poses=n_poses, n_lms=4 * n_poses)
    jcfg = dataclasses.replace(jcfg, band_width=jasm.band_width_of(jp))
    if mask:
        m = np.asarray(jp.poses.mask).copy()
        m[3, :6] = False
        m[5, 7] = False
        jp = dataclasses.replace(jp, poses=dataclasses.replace(
            jp.poses, mask=jnp.asarray(m)))
    jp = jprob.prepare_landmarks(jp, jcfg)
    if marg_active:
        rng = np.random.default_rng(1)
        n = jp.marg.H.shape[0]
        A = rng.standard_normal((n, n)) * 0.1
        jp = dataclasses.replace(jp, marg=dataclasses.replace(
            jp.marg, H=jnp.asarray(A @ A.T),
            g=jnp.asarray(rng.standard_normal(n)),
            lin_t=jp.marg.lin_t + 0.01, active=jnp.ones((), bool)))
    return jp, jcfg, to_torch(jp), torch_config(jcfg)


def _blocks(jp, jcfg, tp, tcfg, use_imu, with_precond):
    jie = _j_imu_eval(jp, jcfg, True, True) if use_imu else None
    tie = tstep._imu_eval(tp, tcfg, True, True) if use_imu else None
    want, jmH = jax.jit(lambda p, ie: jcg.assemble_blocks(
        p, jcfg, ie, with_precond=with_precond))(jp, jie)
    got, tmH = tcg.assemble_blocks(tp, tcfg, tie, with_precond=with_precond)
    return want, jmH, got, tmH


@pytest.mark.parametrize("with_precond", [True, False])
@pytest.mark.parametrize("case", ["imu", "no_imu", "marg_prior"])
def test_block_system_matches(case, with_precond):
    jp, jcfg, tp, tcfg = _case(marg_active=case == "marg_prior")
    want, jmH, got, tmH = _blocks(jp, jcfg, tp, tcfg, case != "no_imu",
                                  with_precond)
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if name == "pj":
            for f in w._fields:
                if getattr(w, f) is not None:
                    assert_rel(getattr(g, f), getattr(w, f), TOL, f"pj.{f}")
        elif w is None:
            assert g is None, name
        else:
            assert_rel(g, w, TOL, name)
    assert (tmH is None) == (jmH is None)
    if jmH is not None:
        assert_rel(tmH, jmH, TOL, "marg_H")


def test_block_system_rejects_a_calibration_block():
    """The banded solvers' gate rejects a calibration block (ba_tpu's
    `_build_and_solve` gate): with `use_banded_solver` or `schur_on_band`
    such a build takes the dense path, with `use_cg_solver` the PCG, whose
    block system carries the calibration block (held against ba_tpu in
    tests/test_torch_cg_calib.py)."""
    _, _, tp, tcfg = _case(mask=False)
    cfg = dataclasses.replace(tcfg, calib_size=5)
    P, D = tp.poses.q.shape[0], cfg.pose_dim
    assert 0 < cfg.band_width <= P
    for gate in ("use_banded_solver", "schur_on_band"):
        c = dataclasses.replace(cfg, **{gate: True})
        assert tstep._reduced_path(tp, c)[0] == "dense", gate
    assert tstep._reduced_path(tp, dataclasses.replace(
        tcfg, schur_on_band=True))[0] == "schur_on_band"
    c = dataclasses.replace(cfg, use_banded_solver=True, use_cg_solver=True)
    assert tstep._reduced_path(tp, c)[0] == "cg"
    bs, _ = tcg.assemble_blocks(tp, c)
    assert bs.minv_cal.shape == (5, 5)
    assert bs.rhs_p.shape == bs.dscale.shape == (P * D + 5,)


@pytest.mark.parametrize("marg_active", [False, True])
def test_back_substitution_and_cauchy_factor_match(marg_active):
    jp, jcfg, tp, tcfg = _case(marg_active=marg_active)
    want, jmH, got, tmH = _blocks(jp, jcfg, tp, tcfg, True, False)
    D, K, P, L, lm, N = jasm.dims(jp, jcfg)
    dp = np.random.default_rng(2).standard_normal(N) * 1e-3
    assert_rel(tcg.back_substitute_blocks(got, torch.as_tensor(dp), P, D),
               jcg.back_substitute_blocks(want, jnp.asarray(dp), P, D, K),
               TOL, "delta_l")
    assert_rel(tcg.cauchy_factor(got, tmH, P, D),
               jcg.cauchy_factor(want, jmH, P, D, K), TOL, "cauchy alpha")


def test_applies_match_dense_u_and_w():
    """U x, W z and W^T x through the blocks against the dense U and W of
    ba_tpu's general assembly (prior included in U)."""
    jp, jcfg, tp, tcfg = _case(marg_active=True)
    D, K, P, L, lm, N = jasm.dims(jp, jcfg)
    jcfg0 = dataclasses.replace(jcfg, band_width=0)
    asm = jax.jit(lambda p, ie: jasm.assemble(p, jcfg0, imu_eval=ie))(
        jp, _j_imu_eval(jp, jcfg, True, True))
    U, W = np.asarray(asm.U), np.asarray(asm.W)
    _, _, got, tmH = _blocks(jp, jcfg, tp, tcfg, True, False)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(N)
    z = rng.standard_normal((L, lm))
    xp6 = torch.as_tensor(x).reshape(P, D)[:, :6]
    assert_rel(tcg._u_apply(got, torch.as_tensor(x), P, D, K, tmH), U @ x,
               TOL, "U x")
    assert_rel(tcg._w_apply(got, torch.as_tensor(z), P, D, K),
               W @ z.reshape(-1), TOL, "W z")
    assert_rel(tcg._wt_apply(got, xp6).reshape(-1), W.T @ x, TOL, "W^T x")


def test_block_plan_is_reused_across_builds():
    """A plan built once serves the builds of other states of the same
    problem: same system as a build that makes its own plan."""
    _, _, tp, tcfg = _case(mask=False)
    plan = tcg.block_plan(tp, tcfg, band=True)
    tie = tstep._imu_eval(tp, tcfg, True, True)
    tp2 = dataclasses.replace(tp, poses=dataclasses.replace(
        tp.poses, t=tp.poses.t + 0.001))
    tie2 = tstep._imu_eval(tp2, tcfg, True, True)
    for p, ie in ((tp, tie), (tp2, tie2)):
        a, _ = tcg.assemble_blocks(p, tcfg, ie, with_precond=False,
                                   plan=plan)
        b, _ = tcg.assemble_blocks(p, tcfg, ie, with_precond=False)
        for name in ("rhs_sc", "rhs_p", "V", "wb", "cost"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
