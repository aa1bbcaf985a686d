"""K5: the Schur step of the reduced camera system (CUDA).

Replaces the TPU formulation `ba_tpu/solver/assemble.py:finish` (:442):
S = U - W V^-1 W^T and rhs = rhs_p - W V^-1 rhs_l, then the column mask
(1e6 on a masked diagonal, a zero rhs).  The marginalization runs the same
step on its departing system and keeps the leading n rows and columns
(`ba_tpu/solver/window.py:marginalize`, :93-100).  It runs once per dense
build (`solver/assemble.py:finish`) and once per marginalization
(`solver/window.py:marginalize`).

Design (csrc/schur_finish.cu): (1) per 32-row range of W a bitmask of
the landmarks it touches, and the rhs, a warp per row; (2) one block per
64 x 64 (or, when those do not fill the card, 32 x 32) tile of the lower
triangle of S, walking only the landmarks set in both its row and column
masks, in ascending order, with V^-1 applied to the row operand in shared
memory, so W V^-1 never reaches device memory; plain FMA, mirrored to the
upper triangle (S exactly symmetric).  An unsplit walk equals the dense
ordered walk bit for bit.  When S has few tiles (the serving slide) each
tile's walk is split across the blocks of a thread-block cluster, which
find their landmarks themselves and sum their partial tiles in rank order
through distributed shared memory, and the same launch computes the rhs:
one launch instead of two.  U is read through its strides.  Bit-identical
between launches.  `schur_finish.launches` counts calls: one per call,
whether it makes one launch or two.

`schur_finish_plain` is its plain PyTorch version (the body `finish` had);
`solver/assemble.py:schur_step` takes it for CPU tensors.

Bound on an H100: bytes once the structural zeros are skipped (U's lower
triangle, W's n rows and S: ~10.3 MB at the flagship, ~3 us at 3.35 TB/s);
the launch floor at the slide.

Scope: landmark sizes 1 and 3, float32 and float64, any n <= N.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P]


def schur_finish_plain(U, W, vinv, rhs_p, rhs_l, cmask=None, n=None):
    """(S, rhs): S = U - W V^-1 W^T and rhs = rhs_p - W V^-1 rhs_l, cut to
    the leading n rows and columns; with `cmask` ((n,) bool), 1e6 on each
    masked diagonal and a zero rhs there.  U (N, N), W (N, L*lm), vinv
    (L, lm, lm), rhs_p (N,), rhs_l (L*lm,)."""
    N = U.shape[0]
    L, lm, _ = vinv.shape
    W3 = W.reshape(N, L, lm)
    WVi = torch.einsum("nlk,lkj->nlj", W3, vinv).reshape(N, L * lm)
    S = U - WVi @ W.T
    rhs = rhs_p - WVi @ rhs_l
    if n is not None:
        S, rhs = S[:n, :n], rhs[:n]
    if cmask is not None:
        S = S + torch.diag(torch.where(cmask, 0.0, 1e6).to(S.dtype))
        rhs = torch.where(cmask, rhs, 0.0)
    return S, rhs


def _fn(dtype):
    lib = build.load("schur_finish")
    name = {torch.float32: "ba_schur_finish_f32",
            torch.float64: "ba_schur_finish_f64"}[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def schur_finish(U, W, vinv, rhs_p, rhs_l, cmask=None, n=None):
    """`schur_finish_plain` on CUDA tensors: the kernel's mask pass and
    product, counted as one launch."""
    ts = (U, W, vinv, rhs_p, rhs_l) + ((cmask,) if cmask is not None else ())
    dev = U.device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError("schur_finish kernel: every input must be on one "
                         "CUDA device")
    dtype = U.dtype
    if dtype not in (torch.float32, torch.float64) or any(
            t.dtype != dtype for t in (W, vinv, rhs_p, rhs_l)):
        raise TypeError("schur_finish kernel: unsupported dtypes "
                        f"{[t.dtype for t in ts]}")
    N = U.shape[0]
    L, lm, _ = vinv.shape
    n = N if n is None else n
    if U.shape != (N, N) or W.shape != (N, L * lm) or rhs_p.shape != (N,) \
            or rhs_l.shape != (L * lm,) or vinv.shape != (L, lm, lm) \
            or not 0 <= n <= N:
        raise ValueError(f"schur_finish kernel: shapes U {tuple(U.shape)}, "
                         f"W {tuple(W.shape)}, vinv {tuple(vinv.shape)}, "
                         f"rhs_p {tuple(rhs_p.shape)}, rhs_l "
                         f"{tuple(rhs_l.shape)}, n {n}")
    if lm not in (1, 3):
        raise ValueError(f"schur_finish kernel: landmark size {lm} (takes "
                         "1 and 3)")
    if cmask is not None and (cmask.dtype != torch.bool
                              or cmask.shape != (n,)):
        raise ValueError(f"schur_finish kernel: cmask must be ({n},) bool")
    W, vinv, rhs_p, rhs_l = (t.contiguous() for t in (W, vinv, rhs_p, rhs_l))
    # U is read through its strides: the general path's U is a transposed
    # view, which would cost a full copy
    if min(U.stride()) < 1:
        U = U.contiguous()
    if cmask is not None:
        cmask = cmask.contiguous()
    S = torch.empty((n, n), dtype=dtype, device=dev)
    rhs = torch.empty((n,), dtype=dtype, device=dev)
    # the mask pass's scratch: a bitmask over landmarks per 32 rows of W
    mask = torch.empty((max(1, -(-n // 32) * -(-L // 32)),),
                       dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn(dtype)(U.data_ptr(), U.stride(0), U.stride(1), W.data_ptr(),
                    L * lm, lm,
                    vinv.data_ptr(), rhs_p.data_ptr(), rhs_l.data_ptr(),
                    None if cmask is None else cmask.data_ptr(), n,
                    S.data_ptr(), rhs.data_ptr(), mask.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"schur_finish kernel launch failed: CUDA error "
                           f"{rc}")
    schur_finish.launches += 1
    return S, rhs


schur_finish.launches = 0


def schedule(n, L, lm, device=None):
    """(tile rows, cluster blocks per tile) that the kernel takes on
    `device` (a CUDA device) for n rows and L landmarks of size lm: the
    launch's own choice, read from csrc/schur_finish.cu."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        rc = build.load("schur_finish").ba_schur_schedule(n, L, lm, out)
    if rc != 0:
        raise ValueError(f"schur_finish schedule: n {n}, L {L}, lm {lm}")
    return out[0], out[1]
