"""Self-calibration in the port against ba_tpu (f64, CPU, plain versions of
the kernels), on the reference's fullest template configuration
<R,1,15,5,true>: 15-dim states, inverse-depth landmarks, five FOV
intrinsics and the six T_vs tangents (tests/test_selfcal.py:126-152).

The calibration columns of the reprojection and the IMU evaluation with
15-dim states (and rotation only) agree to 1e-10; the assembled system with
its calibration block (S, rhs, U, W, V) to 1e-9; one GN and one dogleg
iteration, whose `apply_update` moves the intrinsics and T_vs and
re-unprojects the rays, to 1e-9; `dump_system` writes ba_tpu's seven files
to 1e-9.  The solves are in test_torch_selfcal_solve.py.

The simulator's trajectory turns about the vertical only, so the T_vs
translation along that axis is unobservable: with it free, the GN step
along it is set by rounding (it reaches 1e5 m) and no two implementations
agree on it.  The steps and solves compared here hold the T_vs translation
frozen (`tvs_translation_staging` with `tvs_translation_active` off).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

import ba_tpu.core.problem as jprob
from ba_tpu.core import lie as jlie
from ba_tpu.core.residuals import imu as jimu
from ba_tpu.core.residuals import reprojection as jrp
from ba_tpu.io import simulate_vins as jsv
from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import linear as jlin
from ba_tpu.solver import step as jstep
from ba_tpu_torch.core.residuals import imu as timu
from ba_tpu_torch.core.residuals import reprojection as trp
from ba_tpu_torch.solver import assemble as tasm
from ba_tpu_torch.solver import linear as tlin
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_rel, assert_tree_rel, to_torch,
                               torch_config)

CALIB_ERR = np.array([2.0, -2.0, 3.0, -2.0, 0.01])
TVS_ROT, TVS_T = [0.01, -0.008, 0.012], [0.01, -0.02, 0.015]


@functools.lru_cache(maxsize=None)
def selfcal_problem(n_poses=10, n_lms=60, staged=False, frozen=True):
    """(JAX problem, JAX config) of a noiseless <R,1,15,5,true> scene with
    moved intrinsics and T_vs, as tests/test_selfcal.py builds it; the
    T_vs translation `frozen`, or `staged`."""
    sim = jsv.simulate(n_poses=n_poses, n_lms=n_lms, seed=13)
    cfg = jprob.BAConfig(pose_dim=15, lm_size=1, calib_size=5, do_tvs=True,
                         use_dogleg=True, error_change_threshold=0.0,
                         param_change_threshold=1e-10,
                         tvs_translation_staging=staged or frozen,
                         tvs_translation_active=not frozen)
    p, _, _ = jsv.build_problem(sim, cfg, perturb=0.0, seed=14)
    params = np.asarray(p.rig.params).copy()
    params[0, :5] += CALIB_ERR
    dq = jlie.so3_exp(jnp.asarray(TVS_ROT))
    rig = dataclasses.replace(
        p.rig, params=jnp.asarray(params),
        tvs_q=jlie.quat_mul(p.rig.tvs_q[0], dq)[None, :],
        tvs_t=p.rig.tvs_t + jnp.asarray([TVS_T]))
    return dataclasses.replace(p, rig=rig), cfg


def prepared(**kw):
    jp, jcfg = selfcal_problem(**kw)
    jp = jprob.prepare_landmarks(jp, jcfg)
    return jp, jcfg, to_torch(jp), torch_config(jcfg)


@pytest.mark.parametrize("jac", [True, False])
def test_reprojection_calibration_columns_match(jac):
    jp, jcfg, tp, tcfg = prepared()
    want = jrp.evaluate(jp, jcfg, jac)
    got = trp.evaluate_plain(tp, tcfg, jac)
    assert got.j_cal.shape[-1] == (11 if jac else 0)
    for name in want._fields:
        assert_rel(getattr(got, name), getattr(want, name), 1e-10, name)


@pytest.mark.parametrize("jac", [True, False])
@pytest.mark.parametrize("rotation_only", [False, True])
def test_imu_evaluate_15dim_matches(jac, rotation_only):
    jp, jcfg, tp, tcfg = prepared()
    jcfg = dataclasses.replace(jcfg, imu_rotation_only=rotation_only)
    tcfg = dataclasses.replace(tcfg, imu_rotation_only=rotation_only)
    want = jimu.evaluate(jp, jcfg, jac)
    got = timu.evaluate(tp, tcfg, jac)
    for name in want._fields:
        assert_rel(getattr(got, name), getattr(want, name), 1e-10, name)


def test_assembly_with_calibration_block_matches():
    jp, jcfg, tp, tcfg = prepared()
    want = jasm.assemble(jp, jcfg, imu_eval=jimu.evaluate(jp, jcfg, True))
    plan = tasm.assembly_plan(tp, tcfg)
    assert plan.band_width == 0 and plan.cc is not None
    got = tasm.assemble(tp, tcfg, imu_eval=timu.evaluate(tp, tcfg, True),
                        plan=plan)
    assert got.S.shape[0] == 10 * 15 + 11
    for name in ("S", "rhs_sc", "U", "rhs_p", "W", "V", "rhs_l", "cost",
                 "col_mask", "proj_w"):
        assert_rel(getattr(got, name), getattr(want, name), 1e-9, name)


@pytest.mark.parametrize("use_dogleg", [False, True])
def test_selfcal_iteration_matches(use_dogleg):
    jp, jcfg, tp, tcfg = prepared()
    if use_dogleg:
        trust = -1.0
        want = jstep.dogleg_iteration(jp, jcfg, True, jnp.asarray(trust))
        got = tstep.dogleg_iteration(tp, tcfg, True,
                                     tp.poses.t.new_full((), trust))
    else:
        want = jstep.gn_iteration(jp, jcfg, True)
        got = tstep.gn_iteration(tp, tcfg, True)
    for name in ("pre_cost", "post_cost", "delta_norm", "accepted",
                 "solver_ok", "trust_radius", "inner_trials"):
        assert_rel(getattr(got, name), getattr(want, name), 1e-9, name)
    assert_tree_rel(got.problem, want.problem, 1e-9)
    # the accepted step moved the calibration and re-unprojected the rays
    assert bool(got.accepted)
    assert float((got.problem.rig.params - tp.rig.params).abs().max()) > 0
    assert float((got.problem.lms.x - tp.lms.x)[:, :3].abs().max()) > 0


def test_apply_update_moves_calibration_and_rays():
    jp, jcfg, tp, tcfg = prepared()
    rng = np.random.default_rng(3)
    N = 10 * 15 + 11
    dp = rng.standard_normal(N) * 1e-3
    dl = rng.standard_normal(jp.lms.x.shape[0]) * 1e-3
    want = jstep.apply_update(jp, jcfg, jnp.asarray(dp), jnp.asarray(dl),
                              0.5)
    got = tstep.apply_update(tp, tcfg, tp.poses.t.new_tensor(dp),
                             tp.poses.t.new_tensor(dl), 0.5)
    assert_tree_rel(got, want, 1e-12)


def test_dump_system_writes_the_same_files(tmp_path):
    jp, jcfg, tp, tcfg = prepared()
    want = jasm.assemble(jp, jcfg, imu_eval=jimu.evaluate(jp, jcfg, True))
    got = tasm.assemble(tp, tcfg, imu_eval=timu.evaluate(tp, tcfg, True))
    jlin.dump_system(want, str(tmp_path / "jax"))
    tlin.dump_system(got, str(tmp_path / "torch"))
    names = sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "torch").iterdir())
    assert len(names) == 7
    for name in names:
        assert_rel(np.loadtxt(tmp_path / "torch" / name),
                   np.loadtxt(tmp_path / "jax" / name), 1e-9, name)
