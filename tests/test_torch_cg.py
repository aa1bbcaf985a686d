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
from ba_tpu_torch.solver import cg as tcg
from ba_tpu_torch.solver import step as tstep

from test_torch_common import (assert_rel, jax_problem, to_torch,
                               torch_config, with_random_prior)

CG = dict(use_cg_solver=True, cg_max_iterations=100, cg_tolerance=1e-6)


def cg_case(prior=False, **cfg):
    """Prepared problems on both sides on the CG path (16 poses, one pose
    with masked dims), with an active random prior when `prior`."""
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


def blocks(jp, jcfg, tp, tcfg):
    """Both packages' block systems (with the preconditioner) of one
    build."""
    jbs, jH = jax.jit(lambda p: jcg.assemble_blocks(
        p, jcfg, jstep._imu_eval(p, jcfg, True, True)))(jp)
    tbs, tH = tcg.assemble_blocks(tp, tcfg,
                                  tstep._imu_eval(tp, tcfg, True, True))
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
