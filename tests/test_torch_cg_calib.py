"""Self-calibration on the matrix-free PCG solver (`use_cg_solver` with a
calibration block of K = calib_dim columns) in the port against ba_tpu's
CG route (f64, CPU, plain versions of the kernels), block by block.

K = 5 (the FOV intrinsics; also with an active marginalization prior),
6 (the T_vs tangents) and 11 (both, on 15-dim states: the reference's
fullest template <R,1,15,5,true>), on 12 poses with the intrinsics and
T_vs moved as tests/test_selfcal.py moves them.  Tolerances, relative to max(1, max |ba_tpu|): the build's rhs_p,
rhs_sc, minv_cal and dscale 1e-9 (the same sums in another order, and a
(K, K) inverse); `s_matvec` and `_precond` on a seeded x 1e-10;
`back_substitute_blocks` and `cauchy_factor` 1e-9; one `solve_reduced_cg`
step at tolerance 1e-12 1e-8 (a PCG of up to 400 iterations amplifies the
order of the sums).  Kernel 6's route on the card, through its plain
versions (the landmark-sorted pack with J_c, the rows and the tiles'
calibration partials), gives the row-order route's S x to 1e-12.

Each K compiles ba_tpu's functions once (`_jax_blocks`), so the file
stays short.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.core import lie as jlie
from ba_tpu.io import simulate_vins as jsv
from ba_tpu.solver import cg as jcg
from ba_tpu.solver import step as jstep
from ba_tpu_torch.kernels import schur_matvec as k6
from ba_tpu_torch.solver import assemble as tasm
from ba_tpu_torch.solver import cg as tcg
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_rel, to_torch, torch_config,
                               with_random_prior)

CALIB_ERR = np.array([2.0, -2.0, 3.0, -2.0, 0.01])
TVS_ROT, TVS_T = [0.01, -0.008, 0.012], [0.01, -0.02, 0.015]
# case: (K, pose_dim, calib_size, do_tvs, an active marginalization prior)
CASES = {"5": (5, 9, 5, False, False), "6": (6, 9, 0, True, False),
         "11": (11, 15, 5, True, False), "5_prior": (5, 9, 5, False, True)}
KS = list(CASES)


@functools.lru_cache(maxsize=None)
def calib_case(case):
    """Prepared problems and configs on both sides on the CG path with a
    calibration block of K columns (12 poses, 36 landmarks, IMU on, the
    calibration moved; with an active random prior in "5_prior")."""
    K, pose_dim, calib_size, do_tvs, prior = CASES[case]
    cfg = jprob.BAConfig(pose_dim=pose_dim, lm_size=1, calib_size=calib_size,
                         do_tvs=do_tvs, use_dogleg=False, use_cg_solver=True,
                         cg_max_iterations=400, cg_tolerance=1e-12)
    sim = jsv.simulate(n_poses=12, n_lms=36, seed=13)
    p, _, _ = jsv.build_problem(sim, cfg, perturb=0.01, seed=14,
                                with_marg_prior=prior)
    if prior:
        p = with_random_prior(p, 0.05, 2)
    params = np.asarray(p.rig.params).copy()
    params[0, :5] += CALIB_ERR
    dq = jlie.so3_exp(jnp.asarray(TVS_ROT))
    p = dataclasses.replace(p, rig=dataclasses.replace(
        p.rig, params=jnp.asarray(params),
        tvs_q=jlie.quat_mul(p.rig.tvs_q[0], dq)[None, :],
        tvs_t=p.rig.tvs_t + jnp.asarray([TVS_T])))
    p = jprob.prepare_landmarks(p, cfg)
    tp, tcfg = to_torch(p), torch_config(cfg)
    assert tcfg.calib_dim == K
    assert tstep._reduced_path(tp, tcfg)[0] == "cg"
    return p, cfg, tp, tcfg


def _x(tp, tcfg, seed):
    P = tp.poses.q.shape[0]
    return np.random.default_rng(seed).standard_normal(
        P * tcfg.pose_dim + tcfg.calib_dim)


@functools.lru_cache(maxsize=None)
def _jax_blocks(case):
    """ba_tpu's CG route on the case, one compile: the build, the Schur
    product and the preconditioner on x, the back-substitution of x's
    pose part, the Cauchy factor, and one `solve_reduced_cg` step."""
    jp, jcfg, tp, tcfg = calib_case(case)
    P, D, K = tp.poses.q.shape[0], jcfg.pose_dim, tcfg.calib_dim
    x = jnp.asarray(_x(tp, tcfg, 3))

    def run(p, x):
        bs, H = jcg.assemble_blocks(p, jcfg, jstep._imu_eval(p, jcfg, True,
                                                             True))
        step = jcg.solve_reduced_cg(bs, H, jcfg, P, D, K)
        return dict(rhs_p=bs.rhs_p, rhs_sc=bs.rhs_sc, minv_cal=bs.minv_cal,
                    dscale=bs.dscale,
                    s_matvec=jcg.s_matvec(bs, x, P, D, K, 1e-8, H),
                    precond=jcg._precond(bs, x, P, D, K),
                    back_sub=jcg.back_substitute_blocks(bs, x, P, D, K),
                    cauchy=jcg.cauchy_factor(bs, H, P, D, K),
                    delta_p=step.delta_p, delta_l=step.delta_l, ok=step.ok)

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(jp, x))


@functools.lru_cache(maxsize=None)
def _torch_blocks(case, schur=False):
    _, _, tp, tcfg = calib_case(case)
    plan = tcg.block_plan(tp, tcfg, schur=schur)
    bs, H = tcg.assemble_blocks(tp, tcfg,
                                tstep._imu_eval(tp, tcfg, True, True),
                                plan=plan)
    return bs, H


@pytest.mark.parametrize("case", KS)
def test_block_system_with_calibration_matches(case):
    K, prior = CASES[case][0], CASES[case][4]
    want = _jax_blocks(case)
    bs, H = _torch_blocks(case)
    assert (H is not None) == prior and bs.minv_cal.shape == (K, K)
    for name in ("rhs_p", "rhs_sc", "minv_cal", "dscale"):
        assert_rel(getattr(bs, name), want[name], 1e-9, name)


@pytest.mark.parametrize("case", KS)
def test_s_matvec_and_precond_with_calibration_match(case):
    _, _, tp, tcfg = calib_case(case)
    want = _jax_blocks(case)
    bs, H = _torch_blocks(case)
    P, D, K = tp.poses.q.shape[0], tcfg.pose_dim, tcfg.calib_dim
    x = torch.as_tensor(_x(tp, tcfg, 3))
    assert_rel(tcg.s_matvec(bs, x, P, D, K, 1e-8, H), want["s_matvec"],
               1e-10, "s_matvec")
    assert_rel(tcg._precond(bs, x, P, D, K), want["precond"], 1e-10,
               "precond")


@pytest.mark.parametrize("case", KS)
def test_back_substitution_and_cauchy_with_calibration_match(case):
    _, _, tp, tcfg = calib_case(case)
    want = _jax_blocks(case)
    bs, H = _torch_blocks(case)
    P, D, K = tp.poses.q.shape[0], tcfg.pose_dim, tcfg.calib_dim
    x = torch.as_tensor(_x(tp, tcfg, 3))
    assert_rel(tcg.back_substitute_blocks(bs, x, P, D, K), want["back_sub"],
               1e-9, "back_substitute_blocks")
    assert_rel(tcg.cauchy_factor(bs, H, P, D, K), want["cauchy"], 1e-9,
               "cauchy_factor")


@pytest.mark.parametrize("case", KS)
def test_solve_reduced_cg_step_with_calibration_matches(case):
    _, _, tp, tcfg = calib_case(case)
    want = _jax_blocks(case)
    bs, H = _torch_blocks(case)
    P, D, K = tp.poses.q.shape[0], tcfg.pose_dim, tcfg.calib_dim
    step = tcg.solve_reduced_cg(bs, H, tcfg, P, D, K)
    assert bool(step.ok) and bool(want["ok"])
    assert_rel(step.delta_p, want["delta_p"], 1e-8, "delta_p")
    assert_rel(step.delta_l, want["delta_l"], 1e-8, "delta_l")


@pytest.mark.parametrize("case", KS)
def test_kernel6_route_with_calibration_gives_the_row_order_s_x(case):
    """Kernel 6's order through its plain versions: the pack with J_c,
    the rows and each tile's calibration partial, the rows summed by pose
    on the plan's out_pose and the partials summed, against the row-order
    route's S x (`schur_matvec_plain`), and the whole Schur product
    through the card's plans (`block_plan(schur=True)`)."""
    _, _, tp, tcfg = calib_case(case)
    bs, H = _torch_blocks(case, schur=True)
    P, D, K = tp.poses.q.shape[0], tcfg.pose_dim, tcfg.calib_dim
    x = torch.as_tensor(_x(tp, tcfg, 5))
    pj, plan = bs.pj, bs.plan.schur
    assert bs.plan.cal is not None and bs.plan.cal.nseg == 1
    pack = k6.schur_pack_plain(pj.j_m, pj.j_r, pj.j_l, plan, 1, pj.j_c)
    assert pack.K == K and pack.rows.shape == (
        pj.j_m.shape[0], k6.record_width(1, x.dtype, K))
    rows, partial = k6.schur_matvec_sorted_plain(pack, plan, bs.vinv,
                                                 x[: P * D], D, x[P * D:])
    assert partial.shape == (plan.tiles.shape[0] - 1, K)
    want_rows, want_k = k6.schur_matvec_plain(
        pj.j_m, pj.j_r, pj.j_l, pj.pose, pj.ref, pj.lm, bs.vinv, x[: P * D],
        D, pj.j_c, x[P * D:])
    got = torch.zeros((P, 6), dtype=x.dtype).index_add_(
        0, plan.out_pose, rows.reshape(-1, 6))
    want = torch.zeros((P, 6), dtype=x.dtype).index_add_(
        0, torch.cat([pj.pose, pj.ref]), want_rows)
    assert_rel(got, want.numpy(), 1e-12, "rows by pose")
    assert_rel(partial.sum(0), want_k.numpy(), 1e-12, "calibration part")
    # the product as `s_matvec` forms it on the card: kernel 6's rows with
    # the unary, binary and IMU rows on `s_rhs`, the tiles' partials on
    # `cal`, one grouped sum
    xm = torch.where(bs.col_mask, x, 0.0)
    rows, partial = k6.schur_matvec_sorted_plain(pack, plan, bs.vinv,
                                                 xm[: P * D], D, xm[P * D:])
    prow, imu = tcg._pose_rows(bs, xm[: P * D].reshape(P, D))
    sums = tasm.seg_sum_groups([(torch.cat([rows.reshape(-1, 6), prow]),
                                 bs.plan.s_rhs), imu,
                                (partial, bs.plan.cal)])
    yk = sums.pop().reshape(K)
    y = tcg._u_finish(sums, xm, P, D, H, yk) + 1e-8 * bs.dscale * xm
    got = torch.where(bs.col_mask, y, x)
    assert_rel(got, tcg.s_matvec(bs, x, P, D, K, 1e-8, H).numpy(), 1e-12,
               "S x")
