"""K5b (band to dense) and K8 (the chunked block-tridiagonal layout, factor
and solve) against ba_tpu on the CPU in f64, inputs made by numpy from a
seed.

  * K5b's plain version (`assemble.band_to_dense_plain`) equals ba_tpu's
    `band_to_dense` bit for bit (tolerance 0) in f64 and f32, on a band
    whose diagonal blocks are not symmetric, so that the order (u + u^T) -
    u shows; a torch walk of the kernel's per-element formula equals it too.
  * K8a: a torch walk of the kernel's tile map (one tile per window,
    chunk and row pose: the scales of the poses around it, its pose's
    scaled band row and the blocks its Dg rows mirror, staged once, then
    its rows of the scaled band, the scaling, Dg and Eg, with identity
    poses and identity chunks) equals the Jacobi scaling, window padding
    and `_chunk_windows` of ba_tpu's `banded_pcg_solve` (:631-656) bit for
    bit (tolerance 0), at F = 2 windows of a pose count that is not a
    multiple of the chunk; so do the port's plain versions
    (`jacobi_scaled`, `chunk_system`).  The scaling itself is held to 2
    ulps: XLA's rsqrt and torch's round differently on some inputs, so
    ba_tpu's sequence then runs from the port's scaling.
  * K8b and K8c in ba_tpu's representation: a torch walk of a blocked
    order (the right-looking Cholesky in 32-column panels, the blocked
    triangular solves, cyclic reduction's level split with the shifted T1
    and the solve's down and up passes, the scan's steps, which are the
    scan kernels') against ba_tpu's `_bcr_factor`, `_bcr_solve`, `_factor`
    and `_solve_factored`, to 1e-12 relative: m = 4, 5 (padded to 8) and 8
    chunks, n = 18 (one panel) and n = 45 and 72 (several), F = 1 and 2
    windows; an indefinite block sets the failure flag where ba_tpu's
    factor is non-finite.
  * K8b and K8c with explicit triangular inverses (the cyclic-reduction
    kernels): `bcr_factor_plain` / `bcr_solve_plain` on K8a's padded layout
    against ba_tpu's `_bcr_factor` / `_bcr_solve` in f64, x = S^-1 b to
    1e-10 and every level reconstructed (Li, W, V, the next D' and E') to
    1e-12, at m = 4, 5, 8 and 11 chunks, n = 18, 45 and 72, F = 1 and 2; a
    torch walk of the kernels' tile, panel and level order, padding
    skipped, equal to the plain versions bit for bit; the indefinite-block
    flag; and in f32 the solve's normwise backward error within
    K8_RES_FACTOR (4) of `_bcr_solve`'s on a Jacobi-scaled band with eps =
    1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_tpu.solver import assemble as jasm
from ba_tpu.solver import banded as jband
from ba_tpu_torch.core.problem import BAConfig
from ba_tpu_torch.kernels import chunk_tridiag as k8
from ba_tpu_torch.solver import assemble as tasm
from ba_tpu_torch.solver import banded as tband

from test_torch_common import assert_rel

TS = 32        # the kernels' panel width (csrc/chunk_blas.cuh)


def _band(rng, P, B, D, asym=0.0):
    """A random SPD block band (P, B, D, D) of one window: the blocks of
    J^T J + 0.1 I over a banded J; `asym` adds a non-symmetric part to the
    diagonal blocks."""
    N = P * D
    J = np.zeros((N + B * D, N))
    for p in range(P):
        for d in range(min(B, P - p)):
            J[p * D:(p + 1) * D, (p + d) * D:(p + d + 1) * D] = \
                rng.standard_normal((D, D))
    S = J.T @ J + 0.1 * np.eye(N)
    band = np.zeros((P, B, D, D))
    for p in range(P):
        for d in range(min(B, P - p)):
            band[p, d] = S[p * D:(p + 1) * D, (p + d) * D:(p + d + 1) * D]
    band[:, 0] += asym * rng.standard_normal((P, D, D))
    return band


def _k5b_walk(band):
    """K5b's formula element by element: band[a, b - a] above the block
    diagonal, its transpose below, (u + u^T) - u on it."""
    P, B, D, _ = band.shape
    r = torch.arange(P * D)
    a, i = (r // D)[:, None], (r % D)[:, None]
    b, j = (r // D)[None, :], (r % D)[None, :]
    d = (b - a).abs()
    lo = torch.minimum(a, b)
    inside = d < B
    dc = d.clamp(max=B - 1)
    up = band[lo, dc, i.expand_as(dc), j.expand_as(dc)]
    tr = band[lo, dc, j.expand_as(dc), i.expand_as(dc)]
    diag = (up + tr) - up
    v = torch.where(b > a, up, torch.where(b < a, tr, diag))
    return torch.where(inside, v, torch.zeros((), dtype=band.dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_band_to_dense_plain_is_ba_tpus_bit_for_bit(dtype):
    rng = np.random.default_rng(11)
    band = _band(rng, 9, 4, 3, asym=1e-3).astype(dtype)
    band[7:, 2:] = rng.standard_normal(band[7:, 2:].shape)  # past the last pose
    want = np.asarray(jasm.band_to_dense(jnp.asarray(band)))
    got = tasm.band_to_dense_plain(torch.as_tensor(band))
    assert got.dtype == torch.from_numpy(band).dtype
    assert_rel(got, want, 0.0, "band_to_dense")
    assert np.array_equal(got.numpy(), want)
    # the diagonal blocks are not symmetric, so the order mattered
    assert not np.array_equal(want, want.T)
    assert np.array_equal(_k5b_walk(torch.as_tensor(band)).numpy(), want)


def _ba_tpu_layout(band, F, chunk, eps, scal=None):
    """ba_tpu's banded_pcg_solve (:631-656): the Jacobi scaling, eps, the
    pad of each window and `_chunk_windows`; with `scal` given, that
    scaling in place of its rsqrt."""
    P, B, D, _ = band.shape
    band = jnp.asarray(band)
    diag = jnp.diagonal(band[:, 0], axis1=-2, axis2=-1)
    if scal is None:
        scal = jax.lax.rsqrt(jnp.maximum(diag, 1e-12))
    scal = jnp.asarray(scal)
    up = jnp.clip(jnp.arange(P)[:, None] + jnp.arange(B)[None, :], 0, P - 1)
    band_s = band * scal[:, None, :, None] * scal[up][:, :, None, :]
    band_s = band_s.at[:, 0].add(eps * jnp.eye(D, dtype=band.dtype)[None])
    P_w = P // F
    n_c = -(-P_w // chunk)
    Pp_w = n_c * chunk
    bandF = band_s.reshape(F, P_w, B, D, D)
    if Pp_w > P_w:
        band_p = jnp.zeros((F, Pp_w, B, D, D), band.dtype)
        band_p = band_p.at[:, :P_w].set(bandF)
        band_p = band_p.at[:, P_w:, 0].set(jnp.eye(D, dtype=band.dtype))
        bandF = band_p
    Dg, Eg = jax.vmap(lambda b_: jband._chunk_windows(b_, chunk))(bandF)
    return (np.asarray(band_s), np.asarray(scal), np.asarray(Dg),
            np.asarray(Eg), n_c)


def _k8a_walk(band, F, chunk, m, eps):
    """K8a's tile map (csrc/chunk_layout.cu), tile by tile: one tile per
    (window f, chunk c, row pose k).  A real chunk's tile stages the scales
    of the virtual poses pv - (B - 1) .. pv + (B - 1) (pv = f P_w + c chunk
    + k, clamped to the band), pose a's scaled band row (the products then
    eps; identity past P_w) and the mirrored blocks band_s[pv - d, d], d =
    1 .. min(B - 1, k), then writes band_s[pv], scal[pv] and its D rows of
    Dg (above the diagonal block the row, below it the mirrored blocks, on
    it (u + u^T) - u) and of Eg; a padding chunk's tiles write identity
    and zero rows."""
    P, B, D, _ = band.shape
    P_w = P // F
    n_c = -(-P_w // chunk)
    n = chunk * D
    dt = band.dtype
    lo = torch.tensor(1e-12, dtype=dt)
    eye = torch.eye(D, dtype=dt)
    band_s = torch.full_like(band, float("nan"))
    scal = torch.full((P, D), float("nan"), dtype=dt)
    Dg = torch.full((F, m, n, n), float("nan"), dtype=dt)
    Eg = torch.full_like(Dg, float("nan"))
    q = torch.arange(n)
    k2, j = q // D, q % D
    i = torch.arange(D)[:, None]
    for f in range(F):
        for c in range(m):
            for k in range(chunk):
                rows = slice(k * D, (k + 1) * D)
                if c >= n_c:
                    Dg[f, c, rows] = torch.eye(n, dtype=dt)[rows]
                    Eg[f, c, rows] = 0.0
                    continue
                a = c * chunk + k
                pv = f * P_w + a
                near = torch.clamp(torch.arange(pv - (B - 1), pv + B), 0,
                                   P - 1)
                d_ = torch.diagonal(band[near, 0], dim1=-2, dim2=-1)
                sc = torch.rsqrt(torch.where(d_ < lo, lo, d_))
                s_at = sc[B - 1]
                if a < P_w:
                    row = (band[pv] * s_at[None, :, None]) \
                        * sc[B - 1:][:, None, :]
                    row[0] = row[0] + eps * eye
                    band_s[pv], scal[pv] = row, s_at
                else:
                    row = torch.zeros((B, D, D), dtype=dt)
                    row[0] = eye
                below = torch.zeros((max(B - 1, 1), D, D), dtype=dt)
                for d in range(1, min(B - 1, k) + 1):
                    if a - d < P_w:
                        below[d - 1] = (band[pv - d, d]
                                        * sc[B - 1 - d][:, None]) \
                            * s_at[None, :]
                above = torch.where(
                    k2 - k < B, row[torch.clamp(k2 - k, 0, B - 1), i, j], 0.0)
                mirror = torch.where(
                    k - k2 < B,
                    below[torch.clamp(k - k2 - 1, 0, max(B - 2, 0)), j, i],
                    0.0)
                u, uT = row[0, i, j], row[0, j, i]
                Dg[f, c, rows] = torch.where(
                    k2 > k, above, torch.where(k2 < k, mirror, (u + uT) - u))
                de = chunk + k2 - k
                Eg[f, c, rows] = torch.where(
                    de < B, row[torch.clamp(de, max=B - 1), i, j], 0.0)
    return band_s, scal, Dg, Eg


@pytest.mark.parametrize("dtype,bcr", [(np.float64, True),
                                       (np.float64, False),
                                       (np.float32, True)])
def test_chunk_layout_is_ba_tpus_bit_for_bit(dtype, bcr):
    """F = 2 windows of 11 poses in chunks of 4 (one identity pose per
    window, three chunks, padded to four under cyclic reduction)."""
    rng = np.random.default_rng(3)
    F, P_w, B, D, chunk = 2, 11, 3, 2, 4
    band = np.concatenate([_band(rng, P_w, B, D, asym=1e-3)
                           for _ in range(F)]).astype(dtype)
    eps = 1e-8 if dtype == np.float64 else 1e-4
    tb = torch.as_tensor(band)
    n_c = -(-P_w // chunk)
    m = k8.next_pow2(n_c) if bcr else n_c
    w_bs, w_sc, w_Dg, w_Eg = _k8a_walk(tb, F, chunk, m, eps)
    # XLA's rsqrt and torch's differ by an ulp on some inputs: the scaling
    # is held to that, and everything after it to 0 from the same scaling
    scal = _ba_tpu_layout(band, F, chunk, eps)[1]
    assert_rel(w_sc, scal, 2.0 * np.finfo(dtype).eps, "scal")
    band_s, scal, Dg, Eg, _ = _ba_tpu_layout(band, F, chunk, eps,
                                             w_sc.numpy())
    for got, want, what in ((w_bs, band_s, "band_s"), (w_sc, scal, "scal"),
                            (w_Dg[:, :n_c], Dg, "Dg"),
                            (w_Eg[:, :n_c], Eg, "Eg")):
        assert np.array_equal(got.numpy(), want), what
    n = chunk * D
    assert torch.equal(w_Dg[:, n_c:], torch.eye(n, dtype=tb.dtype).expand(
        F, m - n_c, n, n))
    assert not w_Eg[:, n_c:].any()
    # the port's plain sequence gives the same
    cfg = BAConfig(pose_dim=D, lm_size=1, fleet_size=F, banded_chunk=chunk)
    p_bs, p_sc = tband.jacobi_scaled(tb)
    p_Dg, p_Eg, F_, P_w_, chunk_, n_c_ = tband.chunk_system(p_bs, cfg,
                                                           F * P_w, D)
    assert (F_, P_w_, chunk_, n_c_) == (F, P_w, chunk, n_c)
    for got, want in ((p_bs, band_s), (p_sc, scal), (p_Dg, Dg), (p_Eg, Eg)):
        assert np.array_equal(got.numpy(), want)


# ---- K8b / K8c: a walk of the kernels' per-block order ------------------


def _chol_walk(A):
    """chunk_blas.cuh:chol: right-looking by TS-column panels: the diagonal
    tile column by column, the rows below against it, the trailing lower
    triangle; returns (L, fail)."""
    A = torch.tril(A.clone())
    n = A.shape[0]
    fail = False
    for j0 in range(0, n, TS):
        nb = min(TS, n - j0)
        S = A[j0:j0 + nb, j0:j0 + nb]
        for j in range(nb):
            d = S[j, j]
            fail |= not bool(d > 0) or not bool(torch.isfinite(d))
            S[j, j] = torch.sqrt(d)
            S[j + 1:, j] = S[j + 1:, j] / S[j, j]
            S[j + 1:, j + 1:] -= torch.tril(torch.outer(S[j + 1:, j],
                                                        S[j + 1:, j]))
        R = A[j0 + nb:, j0:j0 + nb]
        for j in range(nb):
            R[:, j] = (R[:, j] - R[:, :j] @ S[j, :j]) / S[j, j]
        fail |= not bool(torch.isfinite(R).all())
        A[j0 + nb:, j0 + nb:] -= torch.tril(R @ R.T)
    return A, fail


def _trsm_walk(L, X, trans):
    """chunk_blas.cuh:trsm: X <- L^-1 X or L^-T X by TS-row panels."""
    X = X.clone()
    n = L.shape[0]
    starts = list(range(0, n, TS))
    for j0 in (reversed(starts) if trans else starts):
        nb = min(TS, n - j0)
        T = L[j0:j0 + nb, j0:j0 + nb]
        P = X[j0:j0 + nb]
        for j in (reversed(range(nb)) if trans else range(nb)):
            if trans:
                P[j] = (P[j] - T[j + 1:, j] @ P[j + 1:]) / T[j, j]
            else:
                P[j] = (P[j] - T[j, :j] @ P[:j]) / T[j, j]
        if trans:
            X[:j0] -= L[j0:j0 + nb, :j0].T @ P
        else:
            X[j0 + nb:] -= L[j0 + nb:, j0:j0 + nb] @ P
    return X


def _cho_walk(L, v):
    return _trsm_walk(L, _trsm_walk(L, v[:, None], False), True)[:, 0]


def _bcr_factor_walk(Dg, Eg):
    """K8b's cyclic reduction, one window: per level the eliminate blocks
    (chol(Dodd), [A^T | B] solved forward and back) then the reduce tiles
    D'_k = (D_2k - B_{k-1}^T Z_{k-1}) - A_k X_k, E'_k = -(A_k Z_k)."""
    m, n = Dg.shape[0], Dg.shape[1]
    M2 = k8.next_pow2(m)
    eye = torch.eye(n, dtype=Dg.dtype)
    D = torch.cat([Dg, eye.expand(M2 - m, n, n)])
    E = torch.cat([Eg, Eg.new_zeros((M2 - m, n, n))])
    levels, fail = [], False
    while D.shape[0] > 1:
        h = D.shape[0] // 2
        cs, Xs, Zs = [], [], []
        for k in range(h):
            c, bad = _chol_walk(D[2 * k + 1])
            fail |= bad
            W = torch.cat([E[2 * k].T, E[2 * k + 1]], dim=1)
            W = _trsm_walk(c, _trsm_walk(c, W, False), True)
            cs.append(c)
            Xs.append(W[:, :n])
            Zs.append(W[:, n:])
        Dn, En = [], []
        for k in range(h):
            t1 = E[2 * k - 1].T @ Zs[k - 1] if k else torch.zeros_like(Xs[0])
            Dn.append((D[2 * k] - t1) - E[2 * k] @ Xs[k])
            En.append(-(E[2 * k] @ Zs[k]))
        levels.append((torch.stack(cs), E[0::2], E[1::2]))
        D, E = torch.stack(Dn), torch.stack(En)
    c0, bad = _chol_walk(D[0])
    levels.append(c0)
    return levels, not (fail or bad)


def _bcr_solve_walk(levels, b, m_orig):
    """K8c's cyclic reduction, one window: down (u_{k-1} and u_k solved by
    each block, b'_k = (b_2k - B_{k-1}^T u_{k-1}) - A_k u_k), the base, up
    (x_odd = Dodd^-1 ((b_odd - A^T x_k) - B x_{k+1}), the interleave)."""
    n = b.shape[1]
    m = 2 ** (len(levels) - 1)
    bs = [torch.cat([b, b.new_zeros((m - m_orig, n))])]
    for c, A, B in levels[:-1]:
        bl = bs[-1]
        h = bl.shape[0] // 2
        u = [_cho_walk(c[k], bl[2 * k + 1]) for k in range(h)]
        bs.append(torch.stack([
            (bl[2 * k] - (B[k - 1].T @ u[k - 1] if k else 0 * bl[0]))
            - A[k] @ u[k] for k in range(h)]))
    x = _cho_walk(levels[-1], bs[-1][0])[None]
    for li in reversed(range(len(levels) - 1)):
        c, A, B = levels[li]
        bl = bs[li]
        h = bl.shape[0] // 2
        out = []
        for k in range(h):
            xr = x[k + 1] if k + 1 < h else torch.zeros_like(x[0])
            rhs = (bl[2 * k + 1] - A[k].T @ x[k]) - B[k] @ xr
            out += [x[k], _cho_walk(c[k], rhs)]
        x = torch.stack(out)
    return x[:m_orig].reshape(-1)


def _scan_walk(Dg, Eg, b):
    """K8b's scan (X = C_{i-1}^-1 E_{i-1}, M_i = X^T, C_i = chol(D_i -
    X^T X)) and K8c's forward and backward passes, one window."""
    m = Dg.shape[0]
    Cs, Ms, fail = [], [], False
    for i in range(m):
        if i == 0:
            X = torch.zeros_like(Dg[0])
        else:
            X = _trsm_walk(Cs[-1], Eg[i - 1], False)
        c, bad = _chol_walk(Dg[i] - torch.tril(X.T @ X))
        fail |= bad
        Cs.append(c)
        Ms.append(X.T)
    ys, yp = [], torch.zeros_like(b[0])
    for i in range(m):
        yp = _trsm_walk(Cs[i], (b[i] - Ms[i] @ yp)[:, None], False)[:, 0]
        ys.append(yp)
    xs, xn = [None] * m, None
    for i in reversed(range(m)):
        v = ys[i] if i + 1 == m else ys[i] - Ms[i + 1].T @ xn
        xn = _trsm_walk(Cs[i], v[:, None], True)[:, 0]
        xs[i] = xn
    return torch.stack(Cs), torch.stack(Ms), torch.cat(xs), not fail


def _chunks(rng, F, m, chunk, D, B):
    """(Dg, Eg, b): F windows of an SPD band in m chunks of `chunk` poses
    (the port's plain layout, whose bit-for-bit match to ba_tpu is tested
    above), and a random rhs."""
    band = np.concatenate([_band(rng, m * chunk, B, D) for _ in range(F)])
    cfg = BAConfig(pose_dim=D, lm_size=1, fleet_size=F, banded_chunk=chunk)
    band_s, _ = tband.jacobi_scaled(torch.as_tensor(band))
    Dg, Eg = tband.chunk_system(band_s, cfg, F * m * chunk, D)[:2]
    return Dg, Eg, torch.as_tensor(rng.standard_normal((F, m, chunk * D)))


@pytest.mark.parametrize("F,m,chunk,D", [(1, 4, 6, 3), (2, 5, 5, 9),
                                         (1, 8, 8, 9)],
                         ids=["m4-n18", "F2-m5-n45", "m8-n72"])
def test_k8_walk_matches_ba_tpu(F, m, chunk, D):
    Dg, Eg, b = _chunks(np.random.default_rng(F * m * chunk), F, m, chunk,
                        D, B=3)
    bcr = jax.vmap(lambda d, e, r: (
        jband._bcr_factor(d, e), jband._bcr_solve(
            jband._bcr_factor(d, e)[0], r, m)))
    (j_levels, j_ok), j_x = bcr(jnp.asarray(Dg.numpy()),
                                jnp.asarray(Eg.numpy()),
                                jnp.asarray(b.numpy()))
    scan = jax.vmap(lambda d, e, r: (
        jband._factor(d, e), jband._solve_factored(
            *jband._factor(d, e)[:2], r)))
    (jC, jM, j_sok), j_y = scan(jnp.asarray(Dg.numpy()),
                                jnp.asarray(Eg.numpy()),
                                jnp.asarray(b.numpy()))
    assert bool(jnp.all(j_ok)) and bool(jnp.all(j_sok))
    for w in range(F):
        levels, ok = _bcr_factor_walk(Dg[w], Eg[w])
        assert ok
        for li, (c, A, B) in enumerate(levels[:-1]):
            jc, jA, jB = (np.asarray(t[w]) for t in j_levels[li])
            assert_rel(c, jc, 1e-12, f"window {w} level {li} chol(Dodd)")
            assert_rel(A, jA, 1e-12, f"window {w} level {li} A")
            assert_rel(B, jB, 1e-12, f"window {w} level {li} B")
        assert_rel(levels[-1], np.asarray(j_levels[-1][w]), 1e-12, "c0")
        x = _bcr_solve_walk(levels, b[w], m)
        assert_rel(x, np.asarray(j_x[w]), 1e-12, f"window {w} bcr solve")
        C, M, y, ok = _scan_walk(Dg[w], Eg[w], b[w])
        assert ok
        assert_rel(C, np.asarray(jC[w]), 1e-12, f"window {w} scan C")
        assert_rel(M, np.asarray(jM[w]), 1e-12, f"window {w} scan M")
        assert_rel(y, np.asarray(j_y[w]), 1e-12, f"window {w} scan solve")


@pytest.mark.parametrize("scan", [False, True], ids=["bcr", "scan"])
def test_k8_walk_flags_an_indefinite_block(scan):
    Dg, Eg, _ = _chunks(np.random.default_rng(2), 1, 4, 6, 3, B=3)
    Dg[0, 1, 4, 4] = -50.0
    if scan:
        ok = _scan_walk(Dg[0], Eg[0], torch.zeros(4, 18,
                                                  dtype=Dg.dtype))[3]
        j_ok = bool(jnp.all(jnp.isfinite(
            jband._factor(jnp.asarray(Dg[0].numpy()),
                          jnp.asarray(Eg[0].numpy()))[0])))
    else:
        ok = _bcr_factor_walk(Dg[0], Eg[0])[1]
        j_ok = bool(jband._bcr_factor(jnp.asarray(Dg[0].numpy()),
                                      jnp.asarray(Eg[0].numpy()))[1])
    assert not ok and not j_ok


# ---- K8b / K8c with explicit triangular inverses (the kernels of
# csrc/chunk_factor.cu and csrc/chunk_solve.cu) --------------------------


def _padded(Dg, Eg):
    """Dg, Eg (F, m, n, n) padded to a power of two with identity chunks and
    zero couplings, as K8a lays them out."""
    F, m, n, _ = Dg.shape
    m2 = k8.next_pow2(m)
    eye = torch.eye(n, dtype=Dg.dtype).expand(F, m2 - m, n, n)
    return (torch.cat([Dg, eye], 1),
            torch.cat([Eg, Eg.new_zeros((F, m2 - m, n, n))], 1))


def _ba_tpu_bcr(Dg, Eg, b):
    """ba_tpu's `_bcr_factor` levels and `_bcr_solve` of each window."""
    m = Dg.shape[1]
    f = jax.vmap(lambda d, e: jband._bcr_factor(d, e))
    levels, ok = f(jnp.asarray(Dg.numpy()), jnp.asarray(Eg.numpy()))
    x = jax.vmap(lambda lv, r: jband._bcr_solve(lv, r, m))(
        levels, jnp.asarray(b.numpy()))
    return levels, ok, np.asarray(x)


@pytest.mark.parametrize("F,m,chunk,D", [(1, 4, 6, 3), (2, 5, 5, 9),
                                         (1, 8, 8, 9), (1, 11, 8, 9),
                                         (2, 11, 6, 3)],
                         ids=["m4-n18", "F2-m5-n45", "m8-n72", "m11-n72",
                              "F2-m11-n18"])
def test_bcr_plain_matches_ba_tpu(F, m, chunk, D):
    """`bcr_factor_plain` on K8a's padded layout (live = m) and
    `bcr_solve_plain` against ba_tpu's `_bcr_factor` and `_bcr_solve` in
    f64: x = S^-1 b to 1e-10; and every level reconstructed to 1e-12: Li_k
    ba_tpu's chol(Dodd_k)^-1, c_k W_k = A_k^T, c_k V_k = B_k, E'_k = -W_k^T
    V_k ba_tpu's next couplings, and the next level's D'_k = (D_2k -
    V_{k-1}^T V_{k-1}) - W_k^T W_k (built up from Dg) ba_tpu's c c^T."""
    Dg, Eg, b = _chunks(np.random.default_rng(10 * F + m), F, m, chunk, D,
                        B=3)
    n = chunk * D
    j_levels, j_ok, j_x = _ba_tpu_bcr(Dg, Eg, b)
    levels, ok = k8.bcr_factor_plain(*_padded(Dg, Eg), live=m)
    assert bool(ok) and bool(jnp.all(j_ok))
    assert len(levels) == len(j_levels)
    x = k8.bcr_solve_plain(levels, b.reshape(F, m * n))
    assert_rel(x, j_x.reshape(F, -1), 1e-10, "x = S^-1 b")
    eye = torch.eye(n, dtype=Dg.dtype)
    D = torch.cat([Dg, eye.expand(F, k8.next_pow2(m) - m, n, n)], 1)
    rs = k8.level_sizes(levels)
    assert rs[0] == min(k8.next_pow2(m), m + 1)
    for li, ((Li, W, V), r) in enumerate(zip(levels[:-1], rs)):
        h, nv = Li.shape[1], V.shape[1]
        jc, jA, jB = (torch.as_tensor(np.array(t)) for t in j_levels[li])
        c = jc[:, :h]
        assert_rel(Li @ c, eye.expand_as(Li), 1e-12, f"level {li} Li c")
        assert_rel(c @ W, jA[:, :h].mT, 1e-12, f"level {li} c W")
        assert_rel(c[:, :nv] @ V, jB[:, :nv], 1e-12, f"level {li} c V")
        rn = r - h
        Dn = D[:, 0:2 * rn:2].clone()
        Dn[:, 1:nv + 1] -= V.mT @ V
        Dn[:, :h] -= W.mT @ W
        En = -(W[:, :nv].mT @ V)
        nxt = j_levels[li + 1]
        if li + 1 < len(levels) - 1:
            na, nb = (torch.as_tensor(np.array(t)) for t in nxt[1:])
            assert_rel(En[:, 0::2], na[:, :len(range(0, nv, 2))], 1e-12,
                       f"level {li} E' even")
            assert_rel(En[:, 1::2], nb[:, :len(range(1, nv, 2))], 1e-12,
                       f"level {li} E' odd")
            cn = torch.as_tensor(np.array(nxt[0]))[:, :rn // 2]
            got = torch.tril(Dn[:, 1::2])
        else:
            cn = torch.as_tensor(np.array(nxt))[:, None]
            got = torch.tril(Dn[:, :1])
        assert_rel(got, torch.tril(cn @ cn.mT), 1e-12, f"level {li} D'")
        D = Dn
    assert_rel(levels[-1] @ torch.as_tensor(np.array(j_levels[-1])),
               eye.expand(F, n, n), 1e-12, "Li0 c0")


def _chol_inv_walk(S):
    """`bcr_chol_inv`'s schedule for one block: per panel of TS columns
    the diagonal tile swept row by row (lane i owning row i), the panel
    U over P (rows J of the inverse) and over T (L_TJ^T) in groups of 8
    outputs, then the trailing rows in groups of 4, each over its columns
    [0, i] (-acc over J, M - acc elsewhere); sums in the kernel's order."""
    n = S.shape[-1]
    M = torch.tril(S)
    bad = False
    for j0 in range(0, n, TS):
        j1 = min(n, j0 + TS)
        nb = j1 - j0
        G = [M[j0 + i, j0:j1].clone() for i in range(nb)]
        for j in range(nb):
            d = G[j][j]
            bad |= not bool(d > 0) or not bool(torch.isfinite(d))
            rs = 1 / torch.sqrt(d)
            w = [G[x][j] * rs if x > j else G[j][x] * rs if x < j else rs
                 for x in range(nb)]
            for i in range(j + 1, nb):
                for k in range(i + 1):
                    G[i][k] = -(w[i] * rs) if k == j else G[i][k] - w[i] * w[k]
            for k in range(j):
                G[j][k] = w[k]
            G[j][j] = rs
        Ljj = torch.tril(torch.stack(G))
        U = M.new_zeros((nb, n))
        U[:, j0:j1] = Ljj
        for e in range(j0 + n - j1):             # column of P or row of T
            rowsj = e < j0
            i = e if rowsj else j1 + e - j0
            for a0 in range(0, nb, 8):
                acc = M.new_zeros(min(8, nb - a0))
                for t in range(min(nb, a0 + 8)):
                    y = M[j0 + t, i] if rowsj else M[i, j0 + t]
                    for q in range(len(acc)):
                        if a0 + q >= t:
                            acc[q] = acc[q] + Ljj[a0 + q, t] * y
                U[a0:a0 + len(acc), i] = acc
        M[j0:j1, :j0] = U[:, :j0]
        M[j0:j1, j0:j1] = Ljj
        for i0 in range(j1, n, 4):
            rows = slice(i0, min(n, i0 + 4))
            cols = min(n, i0 + 4)
            acc = M.new_zeros((rows.stop - i0, cols))
            for t in range(TS):
                acc = acc + U[t, rows, None] * U[t, None, :cols]
            for q in range(rows.stop - i0):
                i = i0 + q
                M[i, j0:j1] = -acc[q, j0:j1]
                M[i, :j0] = M[i, :j0] - acc[q, :j0]
                M[i, j1:i + 1] = M[i, j1:i + 1] - acc[q, j1:i + 1]
    return M, bad or not bool(torch.isfinite(M).all())


def _tile_mm(A, B, n, r0, c0, t_end):
    """A 32 x 32 output tile of A (n, n) @ B (n, n) over t < t_end, summed
    over t in order (`tile_mm`)."""
    r1, c1 = min(n, r0 + TS), min(n, c0 + TS)
    acc = A.new_zeros((r1 - r0, c1 - c0))
    for t in range(t_end):
        acc = acc + A[r0:r1, t, None] * B[None, t, c0:c1]
    return acc


def _bcr_factor_walk_inv(Dg, Eg, live):
    """K8b's schedule, one window: per level the chunks that are not padding
    (r = live + 1 at the top, halved up), Li_k per block, W_k and V_k per
    32 x 32 tile (a tile of Li's rows stopping at its last row, V_k only
    for k < rn - 1), then the lower tiles of D'_k (the V term for 1 <= k
    <= nv, the W term for k < h) and the tiles of E'_k for k < nv."""
    m, n = Dg.shape[0], Dg.shape[-1]
    r = min(m, live + 1)
    D, E = Dg, Eg
    tiles = [(ti * TS, tj * TS) for ti in range(-(-n // TS))
             for tj in range(-(-n // TS))]
    levels, bad = [], False
    while r > 1:
        h, rn = r // 2, r - r // 2
        nv = rn - 1
        Li = torch.zeros((h, n, n), dtype=Dg.dtype)
        for k in range(h):
            Li[k], b_ = _chol_inv_walk(D[2 * k + 1])
            bad |= b_
        W = torch.empty((h, n, n), dtype=Dg.dtype)
        V = torch.empty((nv, n, n), dtype=Dg.dtype)
        for k in range(h):
            for r0, c0 in tiles:
                t_end = min(n, r0 + TS)
                W[k, r0:r0 + TS, c0:c0 + TS] = _tile_mm(
                    Li[k], E[2 * k].T, n, r0, c0, t_end)
                if k < nv:
                    V[k, r0:r0 + TS, c0:c0 + TS] = _tile_mm(
                        Li[k], E[2 * k + 1], n, r0, c0, t_end)
        Dn = torch.zeros((rn, n, n), dtype=Dg.dtype)
        En = torch.zeros((nv, n, n), dtype=Dg.dtype)
        for k in range(rn):
            for r0, c0 in tiles:
                blk = (slice(r0, r0 + TS), slice(c0, c0 + TS))
                if r0 >= c0:
                    acc = D[2 * k][blk]
                    if 1 <= k <= nv:
                        acc = acc - _tile_mm(V[k - 1].T, V[k - 1], n, r0,
                                             c0, n)
                    if k < h:
                        acc = acc - _tile_mm(W[k].T, W[k], n, r0, c0, n)
                    Dn[k][blk] = acc
                if k < nv:
                    En[k][blk] = -_tile_mm(W[k].T, V[k], n, r0, c0, n)
        levels.append((Li, W, V))
        D, E, r = Dn, En, rn
    Li0, b_ = _chol_inv_walk(D[0])
    levels.append(Li0)
    return levels, not (bad or b_)


def _bcr_solve_walk_inv(levels, b):
    """K8c's schedule, one window: down t_k = Li_k b_{2k+1} by rows (each
    stopping at the diagonal), b'_k by columns; the base; up y_k by rows
    (the V term for k < nv), then x_odd = Li_k^T y_k by columns from the
    diagonal down and the interleave; chunks past r read as zero."""
    n = levels[-1].shape[-1]
    rs = k8.level_sizes([tuple(t[None] for t in lv) for lv in levels[:-1]]
                        + [levels[-1][None]])

    def row(Mx, v, i, stop):              # sum_{t < stop} Mx[i, t] v[t]
        s = torch.zeros((), dtype=b.dtype)
        for t in range(stop):
            s = s + Mx[i, t] * v[t]
        return s

    def col(Mx, v, i, start):             # sum_{t >= start} Mx[t, i] v[t]
        s = torch.zeros((), dtype=b.dtype)
        for t in range(n):
            if t >= start:
                s = s + Mx[t, i] * v[t]
        return s

    L = b.shape[0]
    bl = torch.nn.functional.pad(b, (0, rs[0] * n - L)).reshape(rs[0], n)
    ts = []
    for (Li, W, V), r in zip(levels[:-1], rs):
        h, rn = r // 2, r - r // 2
        nv = rn - 1
        t = torch.stack([torch.stack([row(Li[k], bl[2 * k + 1], i, i + 1)
                                      for i in range(n)]) for k in range(h)])
        bn = bl[0:2 * rn:2].clone()
        for k in range(rn):
            for i in range(n):
                v = col(V[k - 1], t[k - 1], i, 0) if 1 <= k <= nv else 0.0
                w = col(W[k], t[k], i, 0) if k < h else 0.0
                bn[k, i] = (bl[2 * k, i] - v) - w
        ts.append(t)
        bl = bn
    Li0 = levels[-1]
    t0 = torch.stack([row(Li0, bl[0], i, i + 1) for i in range(n)])
    x = torch.stack([col(Li0, t0, i, i) for i in range(n)])[None]
    for (Li, W, V), t, r in reversed(list(zip(levels[:-1], ts, rs))):
        h, rn = r // 2, r - r // 2
        nv = rn - 1
        xn = torch.empty((r, n), dtype=b.dtype)
        xn[0::2] = x
        for k in range(h):
            y = torch.stack([
                (t[k, i] - row(W[k], x[k], i, n))
                - (row(V[k], x[k + 1], i, n) if k < nv else 0.0)
                for i in range(n)])
            xn[2 * k + 1] = torch.stack([col(Li[k], y, i, i)
                                         for i in range(n)])
        x = xn
    return x.reshape(-1)[:L]


@pytest.mark.parametrize("F,m,chunk,D", [(1, 4, 6, 3), (2, 5, 5, 9),
                                         (1, 3, 12, 3)],
                         ids=["m4-n18", "F2-m5-n45", "m3-n36"])
def test_k8_inverse_walk_is_the_plain_version_bit_for_bit(F, m, chunk, D):
    """A torch walk of the new kernels' tile, panel and level order,
    padding skipped, equals `bcr_factor_plain` and `bcr_solve_plain`
    bit for bit (f64) on K8a's padded layout."""
    Dg, Eg, b = _chunks(np.random.default_rng(m * chunk), F, m, chunk, D,
                        B=3)
    Dp, Ep = _padded(Dg, Eg)
    n = chunk * D
    L = m * n - 2
    rows = b.reshape(F, -1)[:, :L]
    levels, ok = k8.bcr_factor_plain(Dp, Ep, live=m)
    x = k8.bcr_solve_plain(levels, rows)
    assert bool(ok)
    for w in range(F):
        wl, wok = _bcr_factor_walk_inv(Dp[w], Ep[w], m)
        assert wok
        for (Li, W, V), (pLi, pW, pV) in zip(wl[:-1], levels[:-1]):
            assert torch.equal(Li, pLi[w]) and torch.equal(W, pW[w])
            assert torch.equal(V, pV[w])
        assert torch.equal(wl[-1], levels[-1][w])
        assert torch.equal(_bcr_solve_walk_inv(wl, rows[w]), x[w])


def test_k8_inverse_flags_an_indefinite_block():
    """An indefinite block clears `ok` in `bcr_factor_plain` and in the
    walk, where ba_tpu's factor is non-finite (as
    `test_k8_walk_flags_an_indefinite_block` has it for the old order)."""
    Dg, Eg, _ = _chunks(np.random.default_rng(2), 1, 4, 6, 3, B=3)
    Dg[0, 1, 4, 4] = -50.0
    assert not bool(k8.bcr_factor_plain(Dg, Eg)[1])
    assert not _bcr_factor_walk_inv(Dg[0], Eg[0], 4)[1]
    assert not bool(jband._bcr_factor(jnp.asarray(Dg[0].numpy()),
                                      jnp.asarray(Eg[0].numpy()))[1])


def _residual(Dg, Eg, x, b):
    """Normwise backward error of x (F, m, n) for the chunk system (f64):
    max |S x - b| / (max |S| n max |x| + max |b|) (chip_smoke.py's
    `_chunk_residual`)."""
    Dg, Eg, x, b = (t.double() for t in (Dg, Eg, x, b))
    Dg = torch.tril(Dg) + torch.tril(Dg, -1).mT
    Sx = torch.einsum("fkij,fkj->fki", Dg, x)
    Sx[:, :-1] += torch.einsum("fkij,fkj->fki", Eg[:, :-1], x[:, 1:])
    Sx[:, 1:] += torch.einsum("fkji,fkj->fki", Eg[:, :-1], x[:, :-1])
    scale = (max(float(Dg.abs().max()), float(Eg.abs().max())) * Dg.shape[-1]
             * float(x.abs().max()) + float(b.abs().max()))
    return float((Sx - b).abs().max()) / scale


# chip_smoke.py's K8_RES_FACTOR: the new solve's backward error may be at
# most this multiple of the old plain solve's
K8_RES_FACTOR = 4.0


@pytest.mark.parametrize("F,m,chunk", [(1, 11, 8), (2, 5, 5)],
                         ids=["m11-n72", "F2-m5-n45"])
def test_k8_inverse_f32_backward_error(F, m, chunk):
    """In f32, on a Jacobi-scaled band with eps = 1e-4 on its diagonal (the
    solver's f32 layout), the explicit-inverse solve's normwise backward
    error is at most K8_RES_FACTOR times `_bcr_solve`'s."""
    D = 9
    rng = np.random.default_rng(F * m)
    band = np.concatenate([_band(rng, m * chunk, 3, D) for _ in range(F)])
    cfg = BAConfig(pose_dim=D, lm_size=1, fleet_size=F, banded_chunk=chunk)
    band_s, _ = tband.jacobi_scaled(torch.as_tensor(band))
    band_s[:, 0] += 1e-4 * torch.eye(D, dtype=band_s.dtype)
    Dg, Eg = tband.chunk_system(band_s, cfg, F * m * chunk, D)[:2]
    b = torch.as_tensor(rng.standard_normal((F, m, chunk * D)))
    Dg, Eg, b = Dg.float(), Eg.float(), b.float()
    levels, ok = k8.bcr_factor_plain(*_padded(Dg, Eg), live=m)
    x = k8.bcr_solve_plain(levels, b.reshape(F, -1)).reshape(b.shape)
    old = tband._bcr_solve(tband._bcr_factor(Dg, Eg)[0], b, m).reshape(
        b.shape)
    assert bool(ok)
    res_new, res_old = (_residual(Dg, Eg, v, b) for v in (x, old))
    assert res_new <= K8_RES_FACTOR * res_old, (res_new, res_old)
