"""The port's banded solvers (`solver/banded.py`) against ba_tpu on
identical problems (f64, CPU, plain versions of kernels 2, 7 and 9).

The Schur band (pair and grouped forms, the grouped one forced by patching
`_GROUPED_SP_MIN` in both packages), the band product, the chunk layout,
the scan and cyclic-reduction factorizations on random SPD
block-tridiagonal systems (padded and power-of-two chunk counts, batched),
the PCG wrap, and the arithmetic of kernels 7 and 9 walked in Python over
the kernels' own tables and lane layout.  The same sums in another order:
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


def _kernel7_walk(plan, Wb, vinv, P):
    """Kernel 7's arithmetic in Python over its own tables: for each pose,
    its kept W blocks in CSR order, each with the same landmark's blocks
    at the next slots."""
    B = plan.B
    Wb = Wb.reshape(-1, 6).numpy()
    vinv = vinv.reshape(-1).numpy()
    perm, off = plan.perm.numpy(), plan.offsets.numpy()
    lm, slot, slot_row = plan.lm.numpy(), plan.slot.numpy(), \
        plan.slot_row.numpy()
    out = np.zeros((P, B, 6, 6))
    for a in range(P):
        for row in perm[off[a]:off[a + 1]]:
            u = Wb[row] * vinv[lm[row]]
            for d in range(B - slot[row]):
                q = slot_row[lm[row] * B + slot[row] + d]
                if q >= 0:
                    out[a, d] += np.outer(u, Wb[q])
    return out


def test_kernel7_tables_reproduce_the_plain_correction():
    """The SchurPlan walked as the kernel walks it equals the plain
    grouped correction, with padding W blocks (landmark id L) that must be
    dropped and a landmark that reaches slot B - 1."""
    _, _, tp, tcfg = banded_case(mask=False)
    P, B, L = tp.poses.q.shape[0], tcfg.band_width, tp.lms.x.shape[0]
    rng = np.random.default_rng(4)
    idx = tp.pidx
    n_pad = 5
    wb_pose = torch.cat([idx.wb_pose, torch.zeros(n_pad, dtype=torch.int32)])
    wb_lm = torch.cat([idx.wb_lm, torch.full((n_pad,), L,
                                             dtype=torch.int32)])
    Wb = torch.as_tensor(rng.standard_normal((wb_pose.shape[0], 6, 1)))
    vinv = torch.as_tensor(rng.uniform(0.5, 2.0, (L, 1, 1)))
    plan = k7.schur_plan(wb_pose, wb_lm, P, L, B)
    assert int(plan.slot.max()) == B - 1
    assert bool((plan.slot[-n_pad:] == -1).all())
    assert int(plan.offsets[-1]) == idx.wb_pose.shape[0]
    want = tband.band_schur_plain(wb_pose, wb_lm, Wb, vinv, P, B)
    assert_rel(_kernel7_walk(plan, Wb, vinv, P), want.numpy(), 1e-12,
               "kernel 7 walk")


def _kernel9_walk(band, x):
    """Kernel 9's arithmetic in Python: lanes (slot s, row i) of one warp
    per pose, each over blocks k = s, s + slots, ..., then the slots added
    in order."""
    P, B, D, _ = band.shape
    band, X = band.numpy(), x.numpy().reshape(P, D)
    slots = 32 // D
    y = np.zeros((P, D))
    for q in range(P):
        acc = np.zeros((slots, D))
        for s in range(slots):
            for k in range(s, 2 * B - 1, slots):
                if k < B and q + k < P:
                    acc[s] += band[q, k] @ X[q + k]
                elif k >= B and q - (k - B + 1) >= 0:
                    p = q - (k - B + 1)
                    acc[s] += band[p, k - B + 1].T @ X[p]
        y[q] = acc.sum(0)
    return y.reshape(-1)


@pytest.mark.parametrize("P,B,D", [(9, 4, 3), (13, 13, 9), (7, 1, 6),
                                   (11, 5, 15)])
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
