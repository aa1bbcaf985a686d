"""The port's banded solvers (`solver/banded.py`) against ba_tpu on
identical problems (f64, CPU, plain versions of kernels 2, 7 and 9).

The Schur band (pair and grouped forms, the grouped one forced by patching
`_GROUPED_SP_MIN` in both packages), the band product, the chunk layout,
the scan and cyclic-reduction factorizations on random SPD
block-tridiagonal systems (padded and power-of-two chunk counts, batched),
the PCG wrap, band_S on the grouped form with XYZ landmarks, and the
arithmetic of kernels 7 and 9 walked in Python in the kernels' order:
kernel 7 over its plan, whole and cut into pieces (the two walks equal),
at lm_size 1 and 3; kernel 9 over its tiles, pieces and warps.  The same sums in another order:
1e-9 relative to max(1, max |ba_tpu|) for the band, the rhs and the step,
1e-12 for the factorizations of well-conditioned random systems.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import banded as jband
from ba_tpu.solver import cg as jcg
from ba_tpu.solver import step as jstep
from ba_tpu_torch.kernels import band_matvec as k9
from ba_tpu_torch.kernels import band_schur as k7
from ba_tpu_torch.solver import banded as tband
from ba_tpu_torch.solver import cg as tcg
from ba_tpu_torch.solver import step as tstep

from test_torch_common import assert_rel, banded_case

TOL = 1e-9
_j_imu_eval = jax.jit(jstep._imu_eval, static_argnums=(1, 2, 3))


def _blocks(jp, jcfg, tp, tcfg):
    want, _ = jax.jit(lambda p, ie: jcg.assemble_blocks(
        p, jcfg, ie, with_precond=False))(jp, _j_imu_eval(jp, jcfg, True,
                                                          True))
    got, _ = tcg.assemble_blocks(tp, tcfg,
                                 tstep._imu_eval(tp, tcfg, True, True),
                                 with_precond=False)
    return want, got


@pytest.fixture(params=["pair", "grouped"])
def schur_form(request, monkeypatch):
    """The Schur form of band_S in both packages; the grouped one forced
    by patching `_GROUPED_SP_MIN` (the jit caches do not key on it, so the
    JAX side is traced anew inside each test)."""
    if request.param == "grouped":
        monkeypatch.setattr(jband, "_GROUPED_SP_MIN", 0)
        monkeypatch.setattr(tband, "_GROUPED_SP_MIN", 0)
    return request.param


def test_band_S_matches(schur_form):
    jp, jcfg, tp, tcfg = banded_case()
    D, K, P, L, lm, N = jasm.dims(jp, jcfg)
    want, got = _blocks(jp, jcfg, tp, tcfg)
    jb = jax.jit(lambda p, bs: jband.band_S(p, jcfg, bs, P, D))(jp, want)
    tb = tband.band_S(tp, tcfg, got, P, D)
    assert tband.grouped_schur(tp, tcfg) == (schur_form == "grouped")
    assert_rel(tb, jb, TOL, f"band ({schur_form})")


def _kernel7_walk(plan, Wb, vinv, P, caps=None):
    """Kernel 7's order of work in Python over its own plan: tiles of
    TILE_POSES poses; the run of the tile's W blocks (left rows) and of
    its B + TILE_POSES - 1 poses' (partners) staged whole, or in pieces of
    `caps` (left rows, partner rows), left pieces outside; per output
    block (a, d) a merge walk of pose a's blocks, ascending in landmark,
    against pose a + d's, adding (Wb_a V^-1) Wb_{a+d}^T per shared
    landmark."""
    B, T = plan.B, k7.TILE_POSES
    W, V = Wb.numpy(), vinv.numpy()
    perm, off, lms = plan.perm.numpy(), plan.offsets.numpy(), \
        plan.lm.numpy()
    out = np.zeros((P, B, 6, 6))
    for a0 in range(0, P, T):
        a1, w1 = min(P, a0 + T), min(P, a0 + T + B - 1)
        L0, L1, R1 = off[a0], off[a1], off[w1]
        cl, cr = caps or (max(1, L1 - L0), max(1, R1 - L0))
        nlp, nrp = max(1, -(-(L1 - L0) // cl)), max(1, -(-(R1 - L0) // cr))
        for a in range(a0, a1):
            for d in range(min(B, P - a)):
                acc = np.zeros((6, 6))
                for lp in range(nlp):
                    lp0 = L0 + lp * cl
                    lp1 = min(L1, lp0 + cl)
                    for rp in range(nrp):
                        rp0 = L0 + rp * cr
                        rp1 = min(R1, rp0 + cr)
                        j, je = max(off[a + d], rp0), min(off[a + d + 1], rp1)
                        for r in range(max(off[a], lp0), min(off[a + 1], lp1)):
                            lm = lms[r]
                            while j < je and lms[j] < lm:
                                j += 1
                            if j < je and lms[j] == lm:
                                acc += (W[perm[r]] @ V[lm]) @ W[perm[j]].T
                                j += 1
                out[a, d] = acc
    return out


def _padded_table(tp, n_pad=5):
    """The problem's W block table with padding rows (landmark id L) at
    the end, which both versions must drop."""
    L, idx = tp.lms.x.shape[0], tp.pidx
    wb_pose = torch.cat([idx.wb_pose, torch.zeros(n_pad, dtype=torch.int32)])
    wb_lm = torch.cat([idx.wb_lm, torch.full((n_pad,), L,
                                             dtype=torch.int32)])
    return wb_pose, wb_lm


def _random_wb(rng, n, L, lm):
    """Random W blocks (n, 6, lm) and SPD landmark inverses (L, lm, lm)."""
    Wb = torch.as_tensor(rng.standard_normal((n, 6, lm)))
    A = rng.standard_normal((L, lm, lm))
    vinv = torch.as_tensor(A @ np.swapaxes(A, 1, 2) + lm * np.eye(lm))
    return Wb, vinv


def test_kernel7_tables_reproduce_the_plain_correction():
    """The SchurPlan walked as the kernel walks it equals the plain
    grouped correction, with padding W blocks (landmark id L) that must be
    dropped and a landmark that reaches slot B - 1."""
    _, _, tp, tcfg = banded_case(mask=False)
    P, B, L = tp.poses.q.shape[0], tcfg.band_width, tp.lms.x.shape[0]
    rng = np.random.default_rng(4)
    n_pad = 5
    wb_pose, wb_lm = _padded_table(tp, n_pad)
    Wb, vinv = _random_wb(rng, wb_pose.shape[0], L, 1)
    plan = k7.schur_plan(wb_pose, wb_lm, P, L, B)
    i_loc, kept = k7.slot_of(wb_pose, wb_lm, L, B)
    assert int(i_loc[kept].max()) == B - 1
    assert not bool(kept[-n_pad:].any())
    n_kept = tp.pidx.wb_pose.shape[0]
    assert int(plan.offsets[-1]) == n_kept
    # the kept blocks sorted by (pose, landmark), the padding last
    key = (wb_pose.long() * (L + 1) + wb_lm.long())[plan.perm.long()]
    assert bool((key[1:n_kept] > key[:n_kept - 1]).all())
    assert set(plan.perm[n_kept:].tolist()) == set(range(n_kept,
                                                         n_kept + n_pad))
    want = tband.band_schur_plain(wb_pose, wb_lm, Wb, vinv, P, B)
    assert_rel(_kernel7_walk(plan, Wb, vinv, P), want.numpy(), 1e-12,
               "kernel 7 walk")


@pytest.mark.parametrize("lm", [1, 3], ids=["inverse_depth", "xyz"])
def test_kernel7_walk_in_pieces_matches_whole(lm):
    """Kernel 7's piecewise staging (a tile's run cut into pieces of 3
    left and 5 partner rows) sums every output in the same order as the
    whole run: the two walks are equal, and equal the plain correction to
    1e-12, at lm_size 1 and 3."""
    _, _, tp, tcfg = banded_case(mask=False)
    P, B, L = tp.poses.q.shape[0], tcfg.band_width, tp.lms.x.shape[0]
    wb_pose, wb_lm = _padded_table(tp)
    Wb, vinv = _random_wb(np.random.default_rng(5 + lm), wb_pose.shape[0],
                          L, lm)
    plan = k7.schur_plan(wb_pose, wb_lm, P, L, B)
    whole = _kernel7_walk(plan, Wb, vinv, P)
    cut = _kernel7_walk(plan, Wb, vinv, P, caps=(3, 5))
    assert np.array_equal(cut, whole)
    want = tband.band_schur_plain(wb_pose, wb_lm, Wb, vinv, P, B)
    assert_rel(cut, want.numpy(), 1e-12, f"kernel 7 walk in pieces, lm {lm}")


def test_band_S_xyz_landmarks_grouped_matches(monkeypatch):
    """band_S on the grouped Schur form (forced in both packages, as
    `schur_form` forces it) with XYZ landmarks (lm_size 3) against
    ba_tpu's."""
    monkeypatch.setattr(jband, "_GROUPED_SP_MIN", 0)
    monkeypatch.setattr(tband, "_GROUPED_SP_MIN", 0)
    jp, jcfg, tp, tcfg = banded_case(lm_size=3)
    D, K, P, L, lm, N = jasm.dims(jp, jcfg)
    assert lm == 3 and tband.grouped_schur(tp, tcfg)
    want, got = _blocks(jp, jcfg, tp, tcfg)
    jb = jax.jit(lambda p, bs: jband.band_S(p, jcfg, bs, P, D))(jp, want)
    tb = tband.band_S(tp, tcfg, got, P, D)
    assert_rel(tb, jb, TOL, "band (grouped, lm_size 3)")


def _kernel9_walk(band, x):
    """Kernel 9's order of work in Python: tiles of TILE output poses, each
    tile's pieces (`k9.pieces` at the kernel's schedule) dealt to its
    warps in turn; per piece the lower terms band[p, d]^T x_p of the
    tile's poses p + d into the warp's accumulator, and for an owned row
    the upper terms band[p, d] x_{p+d} summed by lane group g (blocks
    b = g, g + G, ..., G = 32 // D), the groups added in order, then into
    it; each y the sum of the warps' accumulators in warp order."""
    P, B, D, _ = band.shape
    band, X = band.numpy(), x.numpy().reshape(P, D)
    chb, nw = k9.schedule(B)
    G = 32 // D
    y = np.zeros((P, D))
    for q0 in range(0, P, k9.TILE):
        q1 = min(P, q0 + k9.TILE)
        acc = np.zeros((nw, k9.TILE, D))
        for n, pc in enumerate(k9.pieces(q0, P, B, chb)):
            if pc is None:
                continue
            p, da, db = pc
            w = acc[n % nw]
            for d in range(max(da, 1), db):
                if q0 <= p + d < q1:
                    w[p + d - q0] += band[p, d].T @ X[p]
            if p >= q0:
                parts = [np.zeros(D) for _ in range(G)]
                for d in range(da, db):
                    g = (d - da) % G
                    parts[g] = parts[g] + band[p, d] @ X[p + d]
                tot = parts[0]
                for part in parts[1:]:
                    tot = tot + part
                w[p - q0] += tot
        s = acc[0]
        for w in acc[1:]:
            s = s + w
        y[q0:q1] = s[: q1 - q0]
    return y.reshape(-1)


@pytest.mark.parametrize("P,B,D", [(9, 4, 3), (13, 13, 9), (7, 1, 6),
                                   (11, 5, 15), (40, 21, 4), (35, 35, 9),
                                   (20, 6, 32), (70, 50, 1), (150, 7, 9)])
def test_band_matvec_matches(P, B, D):
    rng = np.random.default_rng(P * B)
    band = rng.standard_normal((P, B, D, D))
    band[:, 0] = band[:, 0] + np.swapaxes(band[:, 0], 1, 2)
    pd = np.arange(P)[:, None] + np.arange(B)[None, :]
    band = band * (pd < P)[:, :, None, None]
    x = rng.standard_normal(P * D)
    want = jax.jit(jband.band_matvec)(jnp.asarray(band), jnp.asarray(x))
    got = tband.band_matvec(torch.as_tensor(band), torch.as_tensor(x))
    assert_rel(got, want, 1e-12, "band_matvec")
    dense = np.asarray(jasm.band_to_dense(jnp.asarray(band)))
    assert_rel(got, dense @ x, 1e-12, "band_matvec vs dense")
    assert_rel(_kernel9_walk(torch.as_tensor(band), torch.as_tensor(x)),
               np.asarray(want), 1e-12, "kernel 9 walk")


def test_chunk_windows_match():
    rng = np.random.default_rng(5)
    Fw, P, B, D, chunk = 2, 12, 3, 2, 4
    band = rng.standard_normal((Fw, P, B, D, D))
    Dg, Eg = tband._chunk_windows(torch.as_tensor(band), chunk)
    jD, jE = jax.vmap(lambda b: jband._chunk_windows(b, chunk))(
        jnp.asarray(band))
    assert_rel(Dg, jD, 0.0, "Dg")
    assert_rel(Eg, jE, 0.0, "Eg")


def _tridiag(rng, m, n, lead=()):
    Dg = rng.standard_normal(lead + (m, n, n))
    Dg = np.einsum("...kij,...klj->...kil", Dg, Dg) + 5 * n * np.eye(n)
    Eg = rng.standard_normal(lead + (m, n, n)) * 0.3
    Eg[..., m - 1, :, :] = 0
    b = rng.standard_normal(lead + (m, n))
    return Dg, Eg, b


def _dense_solve(Dg, Eg, b):
    m, n = Dg.shape[0], Dg.shape[1]
    A = np.zeros((m * n, m * n))
    for i in range(m):
        A[i * n:(i + 1) * n, i * n:(i + 1) * n] = Dg[i]
        if i + 1 < m:
            A[i * n:(i + 1) * n, (i + 1) * n:(i + 2) * n] = Eg[i]
            A[(i + 1) * n:(i + 2) * n, i * n:(i + 1) * n] = Eg[i].T
    return np.linalg.solve(A, b.reshape(-1))


@pytest.mark.parametrize("m,n", [(4, 8), (5, 6), (7, 10), (16, 12), (33, 6)])
def test_bcr_and_scan_factorizations_match(m, n):
    """Both factorizations against ba_tpu's and a dense solve; padded (5,
    7, 33) and power-of-two (4, 16) chunk counts."""
    Dg, Eg, b = _tridiag(np.random.default_rng(m * n), m, n)
    x_ref = _dense_solve(Dg, Eg, b)
    levels, ok = tband._bcr_factor(torch.as_tensor(Dg), torch.as_tensor(Eg))
    jx, jok = jax.jit(lambda d, e, r: (
        jband._bcr_solve(jband._bcr_factor(d, e)[0], r, m),
        jband._bcr_factor(d, e)[1]))(jnp.asarray(Dg), jnp.asarray(Eg),
                                     jnp.asarray(b))
    assert bool(ok) and bool(jok)
    x = tband._bcr_solve(levels, torch.as_tensor(b), m)
    assert_rel(x, jx, 1e-12, "bcr")
    assert_rel(x, x_ref, 1e-12, "bcr vs dense")
    C, M, ok = tband._factor(torch.as_tensor(Dg), torch.as_tensor(Eg))
    jC, jM, _ = jax.jit(jband._factor)(jnp.asarray(Dg), jnp.asarray(Eg))
    assert bool(ok)
    assert_rel(C, jC, 1e-12, "C")
    assert_rel(M, jM, 1e-12, "M")
    x = tband._solve_factored(C, M, torch.as_tensor(b))
    assert_rel(x, x_ref, 1e-12, "scan vs dense")


def test_factorizations_batch_over_windows_and_report_failure():
    """A leading window dimension solves each window alone; an indefinite
    chunk gives ok == False with no exception."""
    Dg, Eg, b = _tridiag(np.random.default_rng(7), 6, 5, lead=(3,))
    levels, ok = tband._bcr_factor(torch.as_tensor(Dg), torch.as_tensor(Eg))
    x = tband._bcr_solve(levels, torch.as_tensor(b), 6)
    C, M, ok2 = tband._factor(torch.as_tensor(Dg), torch.as_tensor(Eg))
    x2 = tband._solve_factored(C, M, torch.as_tensor(b))
    assert bool(ok) and bool(ok2)
    for w in range(3):
        x_ref = _dense_solve(Dg[w], Eg[w], b[w])
        assert_rel(x[w], x_ref, 1e-12, f"bcr window {w}")
        assert_rel(x2[w], x_ref, 1e-12, f"scan window {w}")
    Dg[1, 2] = -Dg[1, 2]
    assert not bool(tband._bcr_factor(torch.as_tensor(Dg),
                                      torch.as_tensor(Eg))[1])
    assert not bool(tband._factor(torch.as_tensor(Dg),
                                  torch.as_tensor(Eg))[2])


@pytest.mark.parametrize("bcr", [True, False], ids=["bcr", "scan"])
def test_banded_pcg_solve_matches(bcr):
    """The factor + PCG wrap on a problem's band: 24 poses (band width
    23, two chunks), and 32 poses of a fast trajectory in chunks of its
    band width 8 (four chunks: cyclic reduction engages)."""
    for kw in (dict(n_poses=24), dict(n_poses=32, speed=3.0,
                                      banded_chunk=8)):
        jp, jcfg, tp, tcfg = banded_case(banded_cyclic_reduction=bcr, **kw)
        D, K, P, L, lm, N = jasm.dims(jp, jcfg)
        _, got = _blocks(jp, jcfg, tp, tcfg)
        band = tband.band_S(tp, tcfg, got, P, D)
        jd, jok = jax.jit(lambda bd, r, m: jband.banded_pcg_solve(
            bd, r, m, jcfg, P, D))(jnp.asarray(band.numpy()),
                                    jnp.asarray(got.rhs_sc.numpy()),
                                    jnp.asarray(got.col_mask.numpy()))
        td, tok = tband.banded_pcg_solve(band, got.rhs_sc, got.col_mask,
                                         tcfg, P, D)
        assert bool(tok) and bool(jok)
        assert_rel(td, jd, TOL, f"delta_p, {kw}")
