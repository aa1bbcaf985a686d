"""The port's matrix-free PCG solver (`use_cg_solver`) against ba_tpu on
identical problems (f64, CPU, plain versions of the kernels).

The Schur product `s_matvec` on random x, with and without an active
marginalization prior, agrees to 1e-10 relative; one PCG solve agrees to
1e-9 and stops at the same iteration (ba_tpu's while loop reaches the same
iterate at that iteration's cap and a different one a step earlier);
kernel 6's plain version equals the applies it folds; three GN iterations
keep the cost and step traces within 1e-8.  16 poses, IMU on, band width 0
as `bench_scaling.py`'s `cg` solver leaves it.  The dogleg `solve` with
CG is in test_torch_solver.py.

Kernel 6's route on the card (the landmark-sorted pack, the rows in its
order, the segment plan of the sorted ids), through its plain versions:
summed by pose it equals ba_tpu's projection share of s_matvec (U x and
W V^-1 W^T x through `_proj_u`, `_seg2`, `_wt_apply`, `_w_apply`) to
1e-10 at lm_size 1 and 3, and with the unary, binary and IMU rows on the
plan `s_rhs` it gives the row-order route's S x to 1e-12; the tile table
keeps every landmark in one tile of at most H groups, also with a
landmark longer than a tile and rows whose landmark is out of range.  A
PCG solve with XYZ landmarks (lm_size 3) agrees with ba_tpu to 1e-9.
`block_plan` builds kernel 6's plans only when asked (the CG path on the
card), and a build on the CPU lays out no records.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import ba_tpu.core.problem as jprob
from ba_tpu.solver import cg as jcg
from ba_tpu.solver import step as jstep
from ba_tpu_torch.kernels import schur_matvec as k6
from ba_tpu_torch.solver import assemble as tasm
from ba_tpu_torch.solver import cg as tcg
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_rel, jax_problem, to_torch,
                               torch_config, with_random_prior)

CG = dict(use_cg_solver=True, cg_max_iterations=100, cg_tolerance=1e-6)


def cg_case(prior=False, **cfg):
    """Prepared problems on both sides on the CG path (16 poses, one pose
    with masked dims), with an active random prior when `prior`; `cfg`
    overrides config fields (lm_size 3: XYZ landmarks)."""
    jp, jcfg, _ = jax_problem(n_poses=16, n_lms=48, with_marg_prior=prior)
    jcfg = dataclasses.replace(jcfg, **{**CG, **cfg})
    m = np.asarray(jp.poses.mask).copy()
    m[5, :6] = False
    jp = dataclasses.replace(jp, poses=dataclasses.replace(
        jp.poses, mask=jax.numpy.asarray(m)))
    if prior:
        jp = with_random_prior(jp, 0.05, 2)
    jp = jprob.prepare_landmarks(jp, jcfg)
    tp, tcfg = to_torch(jp), torch_config(jcfg)
    assert tstep._reduced_path(tp, tcfg)[0] == "cg"
    return jp, jcfg, tp, tcfg


def blocks(jp, jcfg, tp, tcfg, plan=None):
    """Both packages' block systems (with the preconditioner) of one
    build; `plan` is the port's `block_plan`, when given."""
    jbs, jH = jax.jit(lambda p: jcg.assemble_blocks(
        p, jcfg, jstep._imu_eval(p, jcfg, True, True)))(jp)
    tbs, tH = tcg.assemble_blocks(tp, tcfg,
                                  tstep._imu_eval(tp, tcfg, True, True),
                                  plan=plan)
    return jbs, jH, tbs, tH


@pytest.mark.parametrize("prior", [False, True], ids=["no_prior", "prior"])
def test_s_matvec_matches(prior):
    jp, jcfg, tp, tcfg = cg_case(prior)
    jbs, jH, tbs, tH = blocks(jp, jcfg, tp, tcfg)
    assert (jH is not None) == prior and (tH is not None) == prior
    P, D = tp.poses.q.shape[0], tcfg.pose_dim
    x = np.random.default_rng(3).standard_normal(P * D)
    want = jax.jit(lambda b, v, H: jcg.s_matvec(b, v, P, D, 0, 1e-8, H))(
        jbs, jax.numpy.asarray(x), jH)
    got = tcg.s_matvec(tbs, torch.as_tensor(x), P, D, 0, 1e-8, tH)
    assert_rel(got, want, 1e-10, "s_matvec")
    assert_rel(tcg._precond(tbs, torch.as_tensor(x), P, D),
               jcg._precond(jbs, jax.numpy.asarray(x), P, D, 0), 1e-10,
               "precond")


def test_schur_matvec_plain_equals_the_applies():
    """Kernel 6's rows, summed by pose, are U x - W V^-1 W^T x of the
    projection family through the applies it replaces."""
    _, _, tp, tcfg = cg_case()
    bs, _ = tcg.assemble_blocks(tp, tcfg, None)
    P, D = tp.poses.q.shape[0], tcfg.pose_dim
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(P * D))
    pj = bs.pj
    rows = k6.schur_matvec_plain(pj.j_m, pj.j_r, pj.j_l, pj.pose, pj.ref,
                                 pj.lm, bs.vinv, x, D)
    got = torch.zeros((P, 6), dtype=x.dtype).index_add_(
        0, torch.cat([pj.pose, pj.ref]), rows)
    xp6 = x.reshape(P, D)[:, :6]
    u = tcg._proj_u(bs, xp6)
    Ux = torch.zeros((P, 6), dtype=x.dtype).index_add_(
        0, torch.cat([pj.pose, pj.ref]), tcg._seg2_rows(pj.j_m, pj.j_r, u, u))
    z = torch.einsum("lij,lj->li", bs.vinv, tcg._wt_apply(bs, xp6))
    WVWx = tcg._w_apply(bs, z, P, D).reshape(P, D)[:, :6]
    assert_rel(got, (Ux - WVWx).numpy(), 1e-12, "projection rows")


def _sorted_rows(bs, x, P, D, lm):
    """Kernel 6's rows through its plain versions: the pack of the
    build's blocks in the plan's order, the rows in that order (Nr, 2, 6)."""
    pj, plan = bs.pj, bs.plan.schur
    pack = k6.schur_pack_plain(pj.j_m, pj.j_r, pj.j_l, plan, lm)
    assert pack.rows.shape == (pj.j_m.shape[0], k6.record_width(lm, x.dtype))
    return k6.schur_matvec_sorted_plain(pack, plan, bs.vinv, x[: P * D], D)


@pytest.mark.parametrize("lm", [1, 3], ids=["inverse_depth", "xyz"])
def test_schur_matvec_sorted_route_equals_ba_tpus_projection_share(lm):
    """Kernel 6's rows in its order, summed by pose over the sorted (pose,
    ref) ids, are ba_tpu's U x - W V^-1 W^T x of the projection family."""
    jp, jcfg, tp, tcfg = cg_case(lm_size=lm)
    jbs, _, tbs, _ = blocks(jp, jcfg, tp, tcfg,
                            tcg.block_plan(tp, tcfg, schur=True))
    P, D = tp.poses.q.shape[0], tcfg.pose_dim
    assert tbs.vinv.shape[1:] == (lm, lm)
    x = np.random.default_rng(6).standard_normal(P * D)
    rows = _sorted_rows(tbs, torch.as_tensor(x), P, D, lm)
    got = torch.zeros((P, 6), dtype=rows.dtype).index_add_(
        0, tbs.plan.schur.out_pose, rows.reshape(-1, 6))

    def share(bs, v):
        pj = bs.pj
        xp6 = v.reshape(P, D)[:, :6]
        xk = jax.numpy.zeros((0,), v.dtype)
        u = jcg._proj_u(bs, xp6, xk)
        Ux = jcg._seg2(pj.j_m, pj.j_r, pj.pose, pj.ref, u, u, P)
        z = jax.numpy.einsum("lij,lj->li", bs.vinv, jcg._wt_apply(bs, xp6,
                                                                  xk))
        return Ux - jcg._w_apply(bs, z, P, D, 0).reshape(P, D)[:, :6]

    want = jax.jit(share)(jbs, jax.numpy.asarray(x))
    assert_rel(got, want, 1e-10, "projection share")


@pytest.mark.parametrize("lm", [1, 3], ids=["inverse_depth", "xyz"])
def test_pack_and_sorted_plan_give_the_row_order_s_x(lm):
    """The card's route of a Schur product (kernel 6's rows in the sorted
    order, then the unary and binary rows, summed on `plan.s_rhs` with the
    IMU group) gives the CPU path's S x (`s_matvec`, row order on
    `plan.rhs`)."""
    _, _, tp, tcfg = cg_case(lm_size=lm)
    bs, mH = tcg.assemble_blocks(tp, tcfg, tstep._imu_eval(tp, tcfg, True,
                                                           True),
                                 plan=tcg.block_plan(tp, tcfg, schur=True))
    P, D = tp.poses.q.shape[0], tcfg.pose_dim
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(P * D))
    lam = 1e-8
    want = tcg.s_matvec(bs, x, P, D, 0, lam, mH)
    xm = torch.where(bs.col_mask, x, 0.0)
    rows, imu = tcg._pose_rows(bs, xm.reshape(P, D))
    buf = torch.cat([_sorted_rows(bs, xm, P, D, lm).reshape(-1, 6), rows])
    sums = tasm.seg_sum_groups([(buf, bs.plan.s_rhs)]
                               + ([imu] if imu is not None else []))
    y = tcg._u_finish(sums, xm, P, D, mH) + lam * bs.dscale * xm
    got = torch.where(bs.col_mask, y, x)
    assert_rel(got, want.numpy(), 1e-12, "S x")


@pytest.mark.parametrize("merged", [0, 8, 400])
def test_schur_plan_tiles_hold_whole_landmarks(merged):
    """The tile table: tile t holds the groups that start in rows [t H,
    (t + 1) H) of the sorted order, whole (a landmark's rows, or one row
    whose landmark id is out of range); with the first `merged` landmarks
    given to one (longer than a tile at 400) and every 50th row's landmark
    out of range."""
    _, _, tp, tcfg = cg_case()
    pr = tp.proj
    L = tp.lms.x.shape[0]
    lm = torch.where(pr.lm < merged, 0, pr.lm.long())
    lm[::50] = L
    ref = tp.lms.ref_pose[pr.lm].long()
    plan = k6.schur_plan(pr.pose, ref, lm, L)
    Nr = lm.shape[0]
    perm = plan.perm.long()
    pose, ref_s, group, lmid = plan.ids.long().unbind(1)
    assert torch.equal(pose, pr.pose.long()[perm])
    assert torch.equal(ref_s, ref[perm])
    key = torch.where(lm < L, lm, -1)[perm]
    assert torch.equal(lmid, key)
    assert torch.equal(plan.out_pose,
                       torch.stack([pose, ref_s], dim=1).reshape(-1))
    nv = int((key >= 0).sum())                # out-of-range rows last
    assert bool((key[:nv] >= 0).all()) and bool((key[nv:] == -1).all())
    assert bool((key[1:nv] >= key[:nv - 1]).all())
    # a group is a landmark's rows, or one out-of-range row
    starts = torch.ones(Nr, dtype=torch.bool)
    starts[1:] = (key[1:] != key[:-1]) | (key[1:] == -1)
    assert torch.equal(group, torch.cumsum(starts.long(), 0) - 1)
    tiles = plan.tiles.long()
    assert tiles.shape == (-(-Nr // k6.H) + 1,)
    assert int(tiles[0]) == 0 and int(tiles[-1]) == Nr
    assert bool((tiles[1:] >= tiles[:-1]).all())
    for t in range(tiles.shape[0] - 1):
        a, b = int(tiles[t]), int(tiles[t + 1])
        if a == b:
            continue
        assert bool(starts[a]) and (b == Nr or bool(starts[b]))
        first = torch.nonzero(starts[a:b]).flatten() + a
        assert bool(((first >= t * k6.H) & (first < (t + 1) * k6.H)).all())
        assert first.numel() <= k6.H
    if merged == 400:
        assert int(torch.bincount(lm[lm < L]).max()) > k6.ROWS


def test_kernel6_plans_only_on_the_cg_path_on_the_card():
    """`block_plan` builds kernel 6's row order and the segsum plan of its
    rows only when asked (`step.solve_plan` asks on the CG path with CUDA
    tensors alone), and a build lays out kernel 6's records only on the
    card."""
    _, _, tp, tcfg = cg_case()
    plan = tstep.solve_plan(tp, tcfg)
    assert plan.schur is None and plan.s_rhs is None
    full = tcg.block_plan(tp, tcfg, schur=True)
    Nr = tp.proj.pose.shape[0]
    assert full.schur.out_pose.shape == (2 * Nr,)
    assert full.s_rhs.perm.shape == full.rhs.perm.shape
    bs, _ = tcg.assemble_blocks(tp, tcfg, None, plan=full)
    assert bs.pack is None and bs.plan.schur is full.schur


def test_solve_reduced_cg_xyz_landmarks_matches():
    """The PCG solve with XYZ landmarks (lm_size 3), through the port's
    plain path, against ba_tpu's."""
    jp, jcfg, tp, tcfg = cg_case(lm_size=3)
    jbs, jH, tbs, tH = blocks(jp, jcfg, tp, tcfg)
    P, D = tp.poses.q.shape[0], tcfg.pose_dim
    want = jax.jit(lambda b, H: jcg.solve_reduced_cg(b, H, jcfg, P, D, 0))(
        jbs, jH)
    got = tcg.solve_reduced_cg(tbs, tH, tcfg, P, D)
    assert bool(got.ok) and bool(want.ok)
    assert got.delta_l.shape == (3 * tp.lms.x.shape[0],)
    for field in ("delta_p", "delta_l"):
        assert_rel(getattr(got, field), getattr(want, field), 1e-9, field)


def test_solve_reduced_cg_matches_and_stops_at_the_same_iteration():
    jp, jcfg, tp, tcfg = cg_case()
    jbs, jH, tbs, tH = blocks(jp, jcfg, tp, tcfg)
    P, D = tp.poses.q.shape[0], tcfg.pose_dim
    res = tcg.pcg_solve(tbs, tH, tcfg, P, D)
    n = int(res.iterations)
    assert 8 < n < CG["cg_max_iterations"]
    assert res.reads == -(-n // tcg.CG_CHECK_EVERY)
    assert res.matvecs == res.reads * tcg.CG_CHECK_EVERY

    def jsolve(cap):
        c = dataclasses.replace(jcfg, cg_max_iterations=cap)
        return jax.jit(lambda b, H: jcg.solve_reduced_cg(b, H, c, P, D, 0))(
            jbs, jH)

    want, at_n, before = jsolve(CG["cg_max_iterations"]), jsolve(n), \
        jsolve(n - 1)
    # ba_tpu's loop stops at iteration n: capping it there changes nothing,
    # capping it one earlier does
    assert np.array_equal(np.asarray(at_n.delta_p), np.asarray(want.delta_p))
    assert not np.array_equal(np.asarray(before.delta_p),
                              np.asarray(want.delta_p))
    got = tcg.solve_reduced_cg(tbs, tH, tcfg, P, D)
    assert bool(got.ok) and bool(want.ok)
    for field in ("delta_p", "delta_l"):
        assert_rel(getattr(got, field), getattr(want, field), 1e-9, field)


def test_cg_gn_solve_fixed_traces_match():
    jp, jcfg, tp, tcfg = cg_case()
    p_j, costs_j, dns_j = jstep.solve_fixed(jp, jcfg, True, 3)
    p_t, costs_t, dns_t = tstep.solve_fixed(tp, tcfg, True, 3)
    assert_rel(costs_t, costs_j, 1e-8, "costs")
    assert_rel(dns_t, dns_j, 1e-8, "delta norms")
    assert_rel(p_t.poses.t, p_j.poses.t, 1e-8, "poses.t")
    assert_rel(p_t.lms.x, p_j.lms.x, 1e-8, "lms.x")
    assert float(costs_t[-1]) < float(costs_t[0])
