"""K8: the chunked block-tridiagonal factor and solve of the banded solver
(CUDA).

Replaces the TPU formulations of `ba_tpu/solver/banded.py`: the Jacobi
scaling and window padding of `banded_pcg_solve` (:631-656),
`_chunk_windows` (:245), `_factor` (:270), `_bcr_factor` (:307),
`_bcr_solve` (:369) and `_solve_factored` (:399).  They run under
`use_banded_solver` (the long trajectory, and a fused fleet's banded
branch): one layout and one factor per build, one solve per PCG iteration
and one before it (5 per build).

  K8a `chunk_layout` (csrc/chunk_layout.cu): one launch writes band_s,
      scal and the chunk blocks Dg, Eg, bit-identical to the plain sequence
      `banded.jacobi_scaled` + `banded.chunk_system` (+ `_bcr_factor`'s
      identity padding).  One block per (window, chunk, row pose) tile
      stages the scales of the poses around it, its pose's band row and
      the blocks its Dg rows mirror, then writes its rows 16 bytes a store;
      a padding chunk's tiles write identity and zero rows.  Bound:
      bytes.
  K8b `bcr_factor` (csrc/chunk_factor.cu): cyclic reduction with explicit
      triangular inverses.  Per level, for each eliminated chunk k, Li_k =
      chol(Dodd_k)^-1 (one block per chunk, the serial part), W_k = Li_k
      A_k^T and V_k = Li_k B_k, then D'_k = (D_2k - V_{k-1}^T V_{k-1}) -
      W_k^T W_k and E'_k = -W_k^T V_k (32 x 32 tiles spread over the card):
      three launches a level and one for the base block's Li0.  The
      levels are [(Li, W, V), ..., Li0]; chunks past the layout's real
      ones (`live`) are identity with zero couplings and are skipped.
      Bound: operations (6.7 n^3 per eliminated chunk).
  K8c `bcr_solve` (csrc/chunk_solve.cu): mat-vecs only, the rows of every
      product split over blocks: down t_k = Li_k b_odd, b'_k = (b_2k -
      V_{k-1}^T t_{k-1}) - W_k^T t_k; up x_odd = Li_k^T ((t_k - W_k x_k) -
      V_k x_{k+1}); two launches a level each way and two for the base.
      Bound: bytes.
  `scan_factor`, `scan_solve` (the same sources): the sequential scan, one
      launch for the factor and two per solve, same contracts as the plain
      `banded._factor` (C, M, ok) and `_solve_factored`.

Products are exact FMA in the working type (no tensor core, so TF32 never
enters).  `bcr_factor_plain` and `bcr_solve_plain` here compute the
kernels' representation in their order of sums (each product summed over
its inner index in order); the tests and chip_smoke.py compare the
kernels with them, and x = S^-1 b with the solver's plain `_bcr_solve`.
The solver takes its plain path (`jacobi_scaled`, `chunk_system`,
`_bcr_factor`, `_factor`, `_bcr_solve`, `_solve_factored`) for CPU
tensors.  Float32 and float64, any chunk size.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_ARGTYPES = {
    ("chunk_layout", "ba_chunk_layout"): [_P, _I, _I, _I, _I, _I, _I, _D, _P,
                                          _P, _P, _P, _P],
    ("chunk_factor", "ba_bcr_chol_inv"): [_P, _I, _I, _I, _I, _I, _I, _P, _P,
                                          _P, _P],
    ("chunk_factor", "ba_bcr_products"): [_P, _I, _P, _I, _I, _I, _I, _P, _P,
                                          _P],
    ("chunk_factor", "ba_bcr_reduce"): [_P, _I, _P, _P, _I, _I, _I, _I, _I,
                                        _P, _P, _P],
    ("chunk_factor", "ba_scan_factor"): [_P, _P, _I, _I, _I, _P, _P, _P, _P,
                                         _P],
    ("chunk_solve", "ba_bcr_down_t"): [_P, _P, _L, _L, _I, _I, _I, _I, _P,
                                       _P],
    ("chunk_solve", "ba_bcr_down_b"): [_P, _P, _P, _P, _L, _L, _I, _I, _I, _I,
                                       _I, _P, _P],
    ("chunk_solve", "ba_bcr_up_y"): [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                                     _P],
    ("chunk_solve", "ba_bcr_up_x"): [_P, _P, _P, _I, _I, _I, _I, _I, _P, _L,
                                     _L, _P],
    ("chunk_solve", "ba_scan_solve"): [_P, _P, _P, _L, _L, _I, _I, _I, _P,
                                       _P, _L, _L, _P],
}


def _call(source, name, dtype, *args):
    """Call `name`_f32/_f64 of csrc/`source`.cu on the current stream and
    raise on a non-zero CUDA error."""
    lib = build.load(source)
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
    fn = getattr(lib, name + suffix)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[(source, name)]
        fn.restype = ctypes.c_int
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{source} kernel {name} launch failed: CUDA "
                           f"error {rc}")


def _check(what, *ts):
    dev = ts[0].device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"{what} kernel: every input must be on one CUDA "
                         f"device")
    dtype = ts[0].dtype
    if dtype not in (torch.float32, torch.float64) or any(
            t.dtype != dtype for t in ts):
        raise TypeError(f"{what} kernel: unsupported dtypes "
                        f"{[t.dtype for t in ts]}")


def next_pow2(m: int) -> int:
    """The chunk count cyclic reduction pads to."""
    return 1 << max(m - 1, 0).bit_length()


def chunk_layout(band, F: int, chunk: int, m: int, eps: float):
    """(band_s, scal, Dg, Eg) of the band (P, B, D, D) of F windows, one
    launch: the Jacobi-scaled band with eps on its diagonal, the scaling
    (P, D), and each window's chunk blocks (F, m, chunk D, chunk D), m >=
    ceil(P / F / chunk), the chunks past it identity (Dg) and zero (Eg)."""
    _check("chunk_layout", band)
    if band.dim() != 4 or band.shape[2] != band.shape[3]:
        raise ValueError(f"chunk_layout kernel: band must be (P, B, D, D), "
                         f"not {tuple(band.shape)}")
    P, B, D, _ = band.shape
    n_c = -(-(P // max(F, 1)) // max(chunk, 1))
    if F < 1 or P % F or chunk < B or m < n_c:
        raise ValueError(f"chunk_layout kernel: P {P}, F {F}, chunk {chunk} "
                         f"(needs >= B = {B}), m {m} (needs >= {n_c})")
    band = band.contiguous()
    n = chunk * D
    band_s = torch.empty_like(band)
    scal = torch.empty((P, D), dtype=band.dtype, device=band.device)
    Dg = torch.empty((F, m, n, n), dtype=band.dtype, device=band.device)
    Eg = torch.empty_like(Dg)
    _call("chunk_layout", "ba_chunk_layout", band.dtype, band.data_ptr(), P,
          B, D, F, chunk, m, float(eps), band_s.data_ptr(), scal.data_ptr(),
          Dg.data_ptr(), Eg.data_ptr())
    chunk_layout.launches += 1
    return band_s, scal, Dg, Eg


def _blocks(Dg, Eg, what):
    _check(what, Dg, Eg)
    if Dg.dim() != 4 or Dg.shape != Eg.shape or Dg.shape[2] != Dg.shape[3]:
        raise ValueError(f"{what} kernel: Dg and Eg must be (F, m, n, n), "
                         f"not {tuple(Dg.shape)}, {tuple(Eg.shape)}")
    return Dg.contiguous(), Eg.contiguous()


TS = 32        # csrc/chunk_factor.cu's panel width


def _level_counts(r: int):
    """(h, rn, nv) of a cyclic-reduction level of r chunks that are not
    padding: h eliminated, rn kept, and the nv = rn - 1 couplings V_k (and
    E'_k) that a later step reads (V_{h-1} of an even r couples into
    padding)."""
    h = r // 2
    return h, r - h, r - h - 1


def _top(m: int, live):
    """The top level's chunks that are not padding, for m chunks of which
    those at or past `live` are identity with zero couplings: the coupling
    of chunk live - 1 may still reach chunk live."""
    live = m if live is None else int(live)
    if not 1 <= live <= m:
        raise ValueError(f"bcr_factor: live {live} outside [1, {m}]")
    return min(m, live + 1)


def level_sizes(levels) -> list:
    """[r_0, ..., 1]: the chunks of each level of a cyclic-reduction factor
    (Li and W hold h of them, V rn - 1, r = h + rn)."""
    rs = [1]
    for Li, _, V in reversed(levels[:-1]):
        rs.insert(0, Li.shape[-3] + V.shape[-3] + 1)
    return rs


def _seq_mm(A, B):
    """A (..., p, q) @ B (..., q, r), each element summed over q in order
    (a multiply, then an add: the kernels' FMA rounds once)."""
    acc = A.new_zeros(A.shape[:-1] + B.shape[-1:])
    for t in range(A.shape[-1]):
        acc = acc + A[..., :, t, None] * B[..., t, None, :]
    return acc


def _seq_mv(M, v):
    return _seq_mm(M, v[..., None])[..., 0]


def chol_inv_plain(S):
    """(Li, bad): Li = chol(S)^-1 of the lower triangle of S (..., n, n),
    by `bcr_chol_inv`'s sweep over panels of TS columns in its order of
    sums: per panel the diagonal tile's Cholesky and inverse in one
    unblocked sweep, the panel's rows of the inverse, L_TJ = S_TJ Li_JJ^T,
    the trailing update by L_TJ, and -L_TJ Li_JJ.  bad (...) marks a
    non-positive or non-finite pivot or a non-finite entry."""
    n = S.shape[-1]
    M = torch.tril(S)
    bad = torch.zeros(S.shape[:-2], dtype=torch.bool, device=S.device)
    for j0 in range(0, n, TS):
        j1 = min(n, j0 + TS)
        G = M[..., j0:j1, j0:j1].clone()
        for j in range(j1 - j0):
            d = G[..., j, j]
            bad = bad | ~(d > 0) | ~torch.isfinite(d)
            rs = 1 / torch.sqrt(d)
            l = G[..., j + 1:, j] * rs[..., None]
            u = G[..., j, :j] * rs[..., None]
            G[..., j + 1:, :j] = G[..., j + 1:, :j] - l[..., :, None] * u[
                ..., None, :]
            G[..., j + 1:, j + 1:] = G[..., j + 1:, j + 1:] - torch.tril(
                l[..., :, None] * l[..., None, :])
            G[..., j + 1:, j] = -(l * rs[..., None])
            G[..., j, :j] = u
            G[..., j, j] = rs
        M[..., j0:j1, :j0] = _seq_mm(G, M[..., j0:j1, :j0])
        M[..., j0:j1, j0:j1] = G
        if j1 < n:
            LT = _seq_mm(M[..., j1:, j0:j1], G.mT)
            acc = _seq_mm(LT, torch.cat([M[..., j0:j1, :j0], LT.mT], -1))
            M[..., j1:, :j0] = M[..., j1:, :j0] - acc[..., :j0]
            M[..., j1:, j1:] = M[..., j1:, j1:] - torch.tril(acc[..., j0:])
            M[..., j1:, j0:j1] = -_seq_mm(LT, G)
    return M, bad | ~torch.isfinite(M).all(-1).all(-1)


def bcr_factor_plain(Dg, Eg, live=None):
    """`bcr_factor`'s representation, in its order of sums: for Dg, Eg (F,
    m, n, n), chunks at or past `live` (default m) identity with zero
    couplings.  A level of r chunks that are not padding eliminates the
    odd ones, k < h: Li_k = chol(D_{2k+1})^-1, W_k = Li_k E_{2k}^T, V_k =
    Li_k E_{2k+1} (k < nv); the kept D'_k = (D_2k - V_{k-1}^T V_{k-1}) -
    W_k^T W_k (lower triangle read), E'_k = -W_k^T V_k.  Returns (levels,
    ok): levels = [(Li, W, V), ..., Li0], Li and W (F, h, n, n), V (F, nv,
    n, n), Li0 (F, n, n); ok a bool tensor."""
    F_, m, n, _ = Dg.shape
    r = _top(m, live)
    D, E = Dg[:, :r], Eg[:, :r]
    bad = torch.zeros((), dtype=torch.bool, device=Dg.device)
    levels = []
    while r > 1:
        h, rn, nv = _level_counts(r)
        Li, b_ = chol_inv_plain(D[:, 1:2 * h:2])
        W = _seq_mm(Li, E[:, 0:2 * h:2].mT)
        V = _seq_mm(Li[:, :nv], E[:, 1:2 * nv:2])
        Dn = D[:, 0:2 * rn:2].clone()
        Dn[:, 1:nv + 1] = Dn[:, 1:nv + 1] - _seq_mm(V.mT, V)
        Dn[:, :h] = Dn[:, :h] - _seq_mm(W.mT, W)
        E = -_seq_mm(W[:, :nv].mT, V)
        bad = bad | b_.any()
        levels.append((Li, W, V))
        D, r = Dn, rn
    Li0, b_ = chol_inv_plain(D[:, 0])
    levels.append(Li0)
    return levels, ~(bad | b_.any())


def _aligned(t):
    """t contiguous at a 16-byte address (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _chol_inv_ws(Dg, h):
    """The workspace `ba_bcr_chol_inv` stages a panel in when shared memory
    has no room for it (h blocks of the windows of Dg (F, m, n, n))."""
    fn = build.load("chunk_factor").ba_bcr_chol_inv_workspace
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I]
        fn.restype = _L
    return Dg.new_empty((fn(Dg.shape[0], h, Dg.shape[-1]),))


def bcr_factor(Dg, Eg, live=None):
    """K8b on CUDA tensors Dg, Eg (F, m, n, n), the chunks at or past
    `live` (default m) identity with zero couplings as `chunk_layout` pads
    them: three launches a level (Li, then W and V, then the next level's
    D and E) and one for the base block.  Returns (levels, ok) as
    `bcr_factor_plain`; ok a device bool."""
    Dg, Eg = _blocks(Dg, Eg, "bcr_factor")
    F_, m, n, _ = Dg.shape
    r = _top(m, live)
    fail = torch.zeros((1,), dtype=torch.int32, device=Dg.device)
    dt = Dg.dtype
    levels = []
    D, E, mD, mE = Dg, Eg, m, m
    while r > 1:
        h, rn, nv = _level_counts(r)
        Li = Dg.new_empty((F_, h, n, n))
        W = Dg.new_empty((F_, h, n, n))
        V = Dg.new_empty((F_, nv, n, n))
        Dn = Dg.new_empty((F_, rn, n, n))
        En = Dg.new_empty((F_, nv, n, n))
        _call("chunk_factor", "ba_bcr_chol_inv", dt, D.data_ptr(), mD, 1, 2,
              h, F_, n, Li.data_ptr(), _chol_inv_ws(Dg, h).data_ptr(),
              fail.data_ptr())
        _call("chunk_factor", "ba_bcr_products", dt, E.data_ptr(), mE,
              Li.data_ptr(), h, nv, F_, n, W.data_ptr(),
              V.data_ptr() if nv else None)
        _call("chunk_factor", "ba_bcr_reduce", dt, D.data_ptr(), mD,
              W.data_ptr(), V.data_ptr() if nv else None, h, nv, rn, F_, n,
              Dn.data_ptr(), En.data_ptr() if nv else None)
        bcr_factor.launches += 3
        levels.append((Li, W, V))
        D, E, mD, mE, r = Dn, En, rn, nv, rn
    Li0 = Dg.new_empty((F_, n, n))
    _call("chunk_factor", "ba_bcr_chol_inv", dt, D.data_ptr(), mD, 0, 1, 1,
          F_, n, Li0.data_ptr(), _chol_inv_ws(Dg, 1).data_ptr(),
          fail.data_ptr())
    bcr_factor.launches += 1
    levels.append(Li0)
    return levels, fail[0] == 0


def scan_factor(Dg, Eg):
    """`banded._factor` on CUDA tensors (F, m, n, n), one launch (one block
    per window stepping through the chunks).  Returns (C, M, ok)."""
    Dg, Eg = _blocks(Dg, Eg, "scan_factor")
    F_, m, n, _ = Dg.shape
    C = torch.empty_like(Dg)
    M = torch.empty_like(Dg)
    xw = Dg.new_empty((F_, n, n))
    fail = torch.zeros((1,), dtype=torch.int32, device=Dg.device)
    _call("chunk_factor", "ba_scan_factor", Dg.dtype, Dg.data_ptr(),
          Eg.data_ptr(), F_, m, n, C.data_ptr(), M.data_ptr(),
          xw.data_ptr(), fail.data_ptr())
    scan_factor.launches += 1
    return C, M, fail[0] == 0


def _rows(b, F_, what):
    if b.dim() != 2 or b.shape[0] != F_:
        raise ValueError(f"{what} kernel: b must be ({F_}, L), not "
                         f"{tuple(b.shape)}")
    return b.contiguous()


def bcr_solve_plain(levels, b):
    """x = S^-1 b through `bcr_factor`'s levels for b (F, L) (elements past
    L read as zero), in `bcr_solve`'s order of terms: down t_k = Li_k
    b_{2k+1}, b'_k = (b_2k - V_{k-1}^T t_{k-1}) - W_k^T t_k; the base x_0 =
    Li0^T Li0 b_0; up y_k = (t_k - W_k x_k) - V_k x_{k+1}, x_{2k+1} =
    Li_k^T y_k, x_{2k} = x_k."""
    F_, L = b.shape
    n = levels[-1].shape[-1]
    rs = level_sizes(levels)
    bl = torch.nn.functional.pad(b, (0, rs[0] * n - L)).reshape(F_, rs[0], n)
    ts = []
    for (Li, W, V), r in zip(levels[:-1], rs):
        h, rn, nv = _level_counts(r)
        t = _seq_mv(Li, bl[:, 1:2 * h:2])
        bn = bl[:, 0:2 * rn:2].clone()
        bn[:, 1:nv + 1] = bn[:, 1:nv + 1] - _seq_mv(V.mT, t[:, :nv])
        bn[:, :h] = bn[:, :h] - _seq_mv(W.mT, t)
        ts.append(t)
        bl = bn
    Li0 = levels[-1]
    x = _seq_mv(Li0.mT, _seq_mv(Li0, bl[:, 0]))[:, None]
    for (Li, W, V), t, r in reversed(list(zip(levels[:-1], ts, rs))):
        h, rn, nv = _level_counts(r)
        y = t - _seq_mv(W, x[:, :h])
        y[:, :nv] = y[:, :nv] - _seq_mv(V, x[:, 1:nv + 1])
        xn = b.new_empty((F_, r, n))
        xn[:, 0::2] = x
        xn[:, 1::2] = _seq_mv(Li.mT, y)
        x = xn
    return x.reshape(F_, -1)[:, :L]


def bcr_solve(levels, b):
    """x = S^-1 b through `bcr_factor`'s levels for b (F, L): chunk k of
    window f is b[f, k n:(k + 1) n], the elements past L read as zero and x
    (F, L) keeps the first L.  Two launches a level down (t = Li b_odd,
    then b'), two for the base, two a level up (y, then x_odd = Li^T y and
    the interleave)."""
    Li0 = levels[-1]
    F_, n, _ = Li0.shape
    _check("bcr_solve", Li0, b, *(t for lv in levels[:-1] for t in lv))
    b = _rows(b, F_, "bcr_solve")
    L = b.shape[1]
    rs = level_sizes(levels)
    if L > rs[0] * n:
        raise ValueError(f"bcr_solve kernel: {L} elements per window, the "
                         f"levels hold {rs[0] * n}")
    dt = b.dtype
    lv = [tuple(_aligned(t) for t in level) for level in levels[:-1]]
    Li0 = _aligned(Li0)
    x = torch.empty_like(b)
    ts = []
    bl, ld = b, L
    valid = L
    for (Li, W, V), r in zip(lv, rs):
        h, rn, nv = _level_counts(r)
        t = b.new_empty((F_, h, n))
        bn = b.new_empty((F_, rn, n))
        _call("chunk_solve", "ba_bcr_down_t", dt, Li.data_ptr(),
              bl.data_ptr(), ld, valid, 1, h, F_, n, t.data_ptr())
        _call("chunk_solve", "ba_bcr_down_b", dt, W.data_ptr(),
              V.data_ptr() if nv else None, t.data_ptr(), bl.data_ptr(), ld,
              valid, h, nv, rn, F_, n, bn.data_ptr())
        ts.append(t)
        bl, ld, valid = bn, rn * n, rn * n
    tb = b.new_empty((F_, 1, n))
    _call("chunk_solve", "ba_bcr_down_t", dt, Li0.data_ptr(), bl.data_ptr(),
          ld, valid, 0, 1, F_, n, tb.data_ptr())
    xk = x if not lv else b.new_empty((F_, 1, n))
    out_ld = L if not lv else n
    _call("chunk_solve", "ba_bcr_up_x", dt, Li0.data_ptr(), tb.data_ptr(),
          None, 0, 1, 0, F_, n, xk.data_ptr(), out_ld, out_ld)
    for li in reversed(range(len(lv))):
        (Li, W, V), t, r = lv[li], ts[li], rs[li]
        h, rn, nv = _level_counts(r)
        y = b.new_empty((F_, h, n))
        _call("chunk_solve", "ba_bcr_up_y", dt, W.data_ptr(),
              V.data_ptr() if nv else None, t.data_ptr(), xk.data_ptr(), h,
              nv, rn, F_, n, y.data_ptr())
        out = x if li == 0 else b.new_empty((F_, r, n))
        out_ld = L if li == 0 else r * n
        _call("chunk_solve", "ba_bcr_up_x", dt, Li.data_ptr(), y.data_ptr(),
              xk.data_ptr(), 1, h, rn, F_, n, out.data_ptr(), out_ld, out_ld)
        xk = out
    bcr_solve.launches += 4 * len(lv) + 2
    return x


bcr_solve.launches = 0


def scan_solve(C, M, b):
    """x = (L L^T)^-1 b through the scan's factors C, M (F, m, n, n) for b
    (F, L), chunks and padding as `bcr_solve`; two launches."""
    _check("scan_solve", C, M, b)
    F_, m, n, _ = C.shape
    if M.shape != C.shape:
        raise ValueError(f"scan_solve kernel: C {tuple(C.shape)}, M "
                         f"{tuple(M.shape)}")
    b = _rows(b, F_, "scan_solve")
    L = b.shape[1]
    if L > m * n:
        raise ValueError(f"scan_solve kernel: {L} elements per window, the "
                         f"factor holds {m * n}")
    C, M = C.contiguous(), M.contiguous()
    y = b.new_empty((F_, m, n))
    x = torch.empty_like(b)
    _call("chunk_solve", "ba_scan_solve", b.dtype, C.data_ptr(),
          M.data_ptr(), b.data_ptr(), L, L, F_, m, n, y.data_ptr(),
          x.data_ptr(), L, L)
    scan_solve.launches += 2
    return x


scan_solve.launches = 0
chunk_layout.launches = 0
bcr_factor.launches = 0
scan_factor.launches = 0
