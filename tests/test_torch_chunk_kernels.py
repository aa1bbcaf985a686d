"""K5b (band to dense) and K8 (the chunked block-tridiagonal layout, factor
and solve) against ba_tpu on the CPU in f64, inputs made by numpy from a
seed.

  * K5b's plain version (`assemble.band_to_dense_plain`) equals ba_tpu's
    `band_to_dense` bit for bit (tolerance 0) in f64 and f32, on a band
    whose diagonal blocks are not symmetric, so that the order (u + u^T) -
    u shows; a torch walk of the kernel's per-element formula equals it too.
  * K8a: a torch walk of the kernel's per-element index map (the scaled
    band, the scaling, Dg and Eg with identity poses and identity chunks)
    equals the Jacobi scaling, window padding and `_chunk_windows` of
    ba_tpu's `banded_pcg_solve` (:631-656) bit for bit (tolerance 0), at F =
    2 windows of a pose count that is not a multiple of the chunk; so do
    the port's plain versions (`jacobi_scaled`, `chunk_system`).  The
    scaling itself is held to 2 ulps: XLA's rsqrt and torch's round
    differently on some inputs, so ba_tpu's sequence then runs from the
    port's scaling.
  * K8b and K8c: a torch walk of the kernels' per-block order (the blocked
    right-looking Cholesky in 32-column panels, the blocked triangular
    solves, cyclic reduction's level split with the shifted T1 and the
    solve's down and up passes, the scan's steps) against ba_tpu's
    `_bcr_factor`, `_bcr_solve`, `_factor` and `_solve_factored`, to 1e-12
    relative: m = 4, 5 (padded to 8) and 8 chunks, n = 18 (one panel) and
    n = 45 and 72 (several), F = 1 and 2 windows; an indefinite block sets
    the failure flag where ba_tpu's factor is non-finite.
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
    """K8a's per-element index map (csrc/chunk_layout.cu): every output
    from the raw band, the products then eps, a diagonal block of Dg as
    (u + u^T) - u, identity poses past P_w and identity chunks past n_c."""
    P, B, D, _ = band.shape
    P_w = P // F
    n_c = -(-P_w // chunk)
    n = chunk * D
    diag = torch.diagonal(band[:, 0], dim1=-2, dim2=-1)
    lo = torch.tensor(1e-12, dtype=band.dtype)
    scal = torch.rsqrt(torch.where(diag < lo, lo, diag))

    def scaled(p, d, i, j):
        up = torch.clamp(p + d, max=P - 1)
        v = (band[p, d, i, j] * scal[p, i]) * scal[up, j]
        return torch.where(d == 0, v + torch.where(i == j, eps, 0.0).to(
            band.dtype), v)

    def windowed(f, a, d, i, j):
        inside = a < P_w
        p = (f * P_w + torch.clamp(a, max=P_w - 1))
        pad = ((d == 0) & (i == j)).to(band.dtype)
        return torch.where(inside, scaled(p, d.clamp(0, B - 1), i, j), pad)

    p, d, i, j = torch.meshgrid(*(torch.arange(s) for s in (P, B, D, D)),
                                indexing="ij")
    band_s = scaled(p, d, i, j)
    f, c, r, q = torch.meshgrid(*(torch.arange(s) for s in (F, m, n, n)),
                                indexing="ij")
    k, i = r // D, r % D
    k2, j = q // D, q % D
    a = c * chunk + k
    zero = torch.zeros((), dtype=band.dtype)
    ident = (r == q).to(band.dtype)
    above = torch.where(k2 - k < B, windowed(f, a, k2 - k, i, j), zero)
    below = torch.where(k - k2 < B, windowed(f, c * chunk + k2, k - k2, j, i),
                        zero)
    u = windowed(f, a, 0 * k, i, j)
    on = (u + windowed(f, a, 0 * k, j, i)) - u
    Dg = torch.where(k2 > k, above, torch.where(k2 < k, below, on))
    Dg = torch.where(c >= n_c, ident, Dg)
    de = chunk + k2 - k
    Eg = torch.where((c < n_c) & (de < B), windowed(f, a, de, i, j), zero)
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
