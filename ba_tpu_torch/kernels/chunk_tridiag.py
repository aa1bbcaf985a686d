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
      identity padding).  Bound: bytes.
  K8b `bcr_factor`, `scan_factor` (csrc/chunk_factor.cu): cyclic reduction
      in two launches per level plus one for the base block, or the scan in
      one launch, on blocked Choleskys and triangular solves whose panels
      pass through shared memory (any n).  Same contracts as the plain
      `banded._bcr_factor` (levels = [(c, A, B), ..., c0], ok) and
      `banded._factor` (C, M, ok); `ok` is set on the device.  Bound:
      operations.
  K8c `bcr_solve`, `scan_solve` (csrc/chunk_solve.cu): one launch per
      level down and up plus the base, or two for the scan; they read the
      factor as K8b or the plain factor left it, so either factor pairs
      with either solve.  Bound: latency, then bytes.

Products are exact f32 FMA (no tensor core, so TF32 never enters).  The
plain versions are `solver/banded.py`'s (`jacobi_scaled`, `chunk_system`,
`_bcr_factor`, `_factor`, `_bcr_solve`, `_solve_factored`); the solver
takes them for CPU tensors.  Float32 and float64, any chunk size.
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
    ("chunk_factor", "ba_bcr_eliminate"): [_P, _I, _I, _I, _P, _P, _P],
    ("chunk_factor", "ba_bcr_reduce"): [_P, _P, _P, _I, _I, _I, _P, _P, _P,
                                        _P],
    ("chunk_factor", "ba_bcr_base"): [_P, _I, _I, _P, _P, _P],
    ("chunk_factor", "ba_scan_factor"): [_P, _P, _I, _I, _I, _P, _P, _P, _P,
                                         _P],
    ("chunk_solve", "ba_bcr_down"): [_P, _P, _P, _L, _L, _I, _I, _I, _P, _P],
    ("chunk_solve", "ba_bcr_base_solve"): [_P, _P, _I, _I, _P, _P],
    ("chunk_solve", "ba_bcr_up"): [_P, _P, _P, _L, _L, _P, _I, _I, _I, _P,
                                   _L, _L, _P],
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


def _reduce_workspace(Dg):
    """An empty tensor of the elements `ba_bcr_reduce` needs in device
    memory at the top level of Dg (F, m, n, n), or None when its strips
    sit in shared memory."""
    F_, m, n, _ = Dg.shape
    fn = getattr(build.load("chunk_factor"), "ba_bcr_reduce_workspace_" + {
        torch.float32: "f32", torch.float64: "f64"}[Dg.dtype])
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I]
        fn.restype = _L
    size = fn(F_, m, n)
    return Dg.new_empty((size,)) if size else None


def bcr_factor(Dg, Eg):
    """`banded._bcr_factor` on CUDA tensors (F, m, n, n), m a power of two
    (`chunk_layout` pads to it): per level one eliminate and one reduce
    launch, and one launch for the base block.  Returns (levels, ok),
    levels = [(c, A, B), ..., c0] outer to inner, A and B views of the
    level's couplings; ok a device bool."""
    Dg, Eg = _blocks(Dg, Eg, "bcr_factor")
    F_, m, n, _ = Dg.shape
    if m != next_pow2(m):
        raise ValueError(f"bcr_factor kernel: {m} chunks, not a power of "
                         f"two")
    fail = torch.zeros((1,), dtype=torch.int32, device=Dg.device)
    dt = Dg.dtype
    levels = []
    D, E = Dg, Eg
    ws = _reduce_workspace(Dg) if m > 1 else None
    while m > 1:
        h = m // 2
        c = Dg.new_empty((F_, h, n, n))
        _call("chunk_factor", "ba_bcr_eliminate", dt, D.data_ptr(), F_, m, n,
              c.data_ptr(), fail.data_ptr())
        Dn = Dg.new_empty((F_, h, n, n))
        En = Dg.new_empty((F_, h, n, n)) if h > 1 else None
        _call("chunk_factor", "ba_bcr_reduce", dt, D.data_ptr(),
              E.data_ptr(), c.data_ptr(), F_, m, n,
              None if ws is None else ws.data_ptr(), Dn.data_ptr(),
              None if En is None else En.data_ptr())
        bcr_factor.launches += 2
        levels.append((c, E[:, 0::2], E[:, 1::2]))
        D, E = Dn, En
        m = h
    c0 = Dg.new_empty((F_, n, n))
    _call("chunk_factor", "ba_bcr_base", dt, D.data_ptr(), F_, n,
          c0.data_ptr(), fail.data_ptr())
    bcr_factor.launches += 1
    levels.append(c0)
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


def _couplings(A, B):
    """The level's couplings as one (F, 2h, n, n) row-major tensor whose
    even chunks are A and odd chunks B: the tensor A is a view of when the
    factor came from `bcr_factor`, else an interleaved copy."""
    F_, h, n, _ = A.shape
    nn = n * n
    if (A.stride() == (2 * h * nn, 2 * nn, n, 1) and B.stride() == A.stride()
            and B.data_ptr() == A.data_ptr() + nn * A.element_size()):
        return A
    return torch.stack([A, B], dim=2).reshape(F_, 2 * h, n, n)


def bcr_solve(levels, b):
    """x = S^-1 b through the cyclic-reduction levels for b (F, L): chunk
    k of window f is b[f, k n:(k + 1) n], the elements past L read as zero
    and x (F, L) keeps the first L.  One launch per level down, one for the
    base, one per level up."""
    c0 = levels[-1]
    F_, n, _ = c0.shape
    _check("bcr_solve", c0, b, *(t for lv in levels[:-1] for t in lv))
    b = _rows(b, F_, "bcr_solve")
    L = b.shape[1]
    top = len(levels) - 1                  # reduction levels
    m_pad = 2 ** top
    if L > m_pad * n:
        raise ValueError(f"bcr_solve kernel: {L} elements per window, the "
                         f"levels hold {m_pad * n}")
    dt = b.dtype
    c0 = c0.contiguous()
    if top == 0:                           # one chunk: the base alone
        bb = torch.nn.functional.pad(b, (0, n - L))
        x = torch.empty_like(bb)
        _call("chunk_solve", "ba_bcr_base_solve", dt, c0.data_ptr(),
              bb.data_ptr(), F_, n, x.data_ptr())
        bcr_solve.launches += 1
        return x[:, :L]
    x = torch.empty_like(b)
    lv_c = [c.contiguous() for c, _, _ in levels[:-1]]
    lv_e = [_couplings(A, B) for _, A, B in levels[:-1]]
    # b (row 0) and x (row 1) of every inner level, (F, m_l, n) each
    sizes = [m_pad >> lv for lv in range(1, top + 1)]
    work = b.new_empty((2, F_ * sum(sizes) * n))
    bufs, o = [], 0
    for s in sizes:
        bufs.append((work[0, o: o + F_ * s * n], work[1, o: o + F_ * s * n]))
        o += F_ * s * n

    def level(lv, row):         # (tensor, row stride, valid) of level lv
        if lv == 0:
            return (b, x)[row], L, L
        m = sizes[lv - 1]
        return bufs[lv - 1][row], m * n, m * n

    for lv in range(top):
        bt, ld, valid = level(lv, 0)
        _call("chunk_solve", "ba_bcr_down", dt, lv_c[lv].data_ptr(),
              lv_e[lv].data_ptr(), bt.data_ptr(), ld, valid, F_,
              m_pad >> lv, n, bufs[lv][0].data_ptr())
    _call("chunk_solve", "ba_bcr_base_solve", dt, c0.data_ptr(),
          bufs[top - 1][0].data_ptr(), F_, n, bufs[top - 1][1].data_ptr())
    for lv in reversed(range(top)):
        bt, ld, valid = level(lv, 0)
        xt, x_ld, x_valid = level(lv, 1)
        _call("chunk_solve", "ba_bcr_up", dt, lv_c[lv].data_ptr(),
              lv_e[lv].data_ptr(), bt.data_ptr(), ld, valid,
              bufs[lv][1].data_ptr(), F_, m_pad >> lv, n, xt.data_ptr(),
              x_ld, x_valid)
    bcr_solve.launches += 2 * top + 1
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
