"""Kernel 9: the symmetric block-band matrix-vector product (CUDA).

Replaces the TPU formulation `ba_tpu/solver/banded.py:band_matvec`
(:229-242), which builds a gathered (P, B - 1, D, D) copy of the band and a
(P, B, D) copy of x on every call.  It runs once per PCG iteration of the
banded solver (`banded_pcg_solve`, 4 per build).  Its plain PyTorch port is
`solver/banded.py:band_matvec_plain`; the wrapper `banded.band_matvec` takes
it for CPU tensors.

Design (csrc/band_matvec.cu): a thread block of WARPS warps owns TILE
consecutive output poses and reads each band block it needs once, using
it twice: block (p, d) gives pose p its upper term and pose p + d its
lower term.  The tile's own rows are read whole, and of the B - 1 rows
before it only the blocks that reach into it, straight from device memory
through L1.  The rows are dealt to the warps in pieces (`schedule`,
`pieces`); each warp sums into its own accumulators, added in warp order
at the end: no atomics, bit-identical between launches.

Bound on an H100: bytes (the 15.9 MB band at the full-width trajectory,
f32; ~4.7 us at 3.35 TB/s).  Float32 and float64, any P, any B, D <= 32.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P] + [_I] * 5 + [_P, _P]

# csrc/band_matvec.cu: output poses and warps per thread block, and the
# most band blocks a piece (one warp's share of a row) takes
TILE = 16
WARPS = 32
PIECE_BLOCKS = 32


def schedule(B: int):
    """(chb, nw): band blocks per piece, a whole row up to PIECE_BLOCKS,
    and warps per thread block."""
    return min(B, PIECE_BLOCKS), WARPS


def pieces(q0: int, P: int, B: int, chb: int):
    """The pieces (p, da, db) of the tile starting at pose q0 in the
    kernel's order (piece n goes to warp n % nw): band row p's blocks
    d in [da, db).  The tile's own rows are whole; a row p < q0 gives the
    blocks that reach into the tile.  Empty pieces (None) keep their
    index."""
    q1 = min(P, q0 + TILE)
    pa = max(0, q0 - B + 1)
    kp = -(-B // chb)
    out = []
    for n in range((q1 - pa) * kp):
        p, k = pa + n // kp, n % kp
        dlo, dhi = 0, min(B, P - p)
        if p < q0:
            dlo, dhi = q0 - p, min(dhi, q1 - p)
        da = dlo + k * chb
        db = min(dhi, da + chb)
        out.append((p, da, db) if da < db else None)
    return out


def _fn(dtype):
    lib = build.load("band_matvec")
    name = {torch.float32: "ba_band_matvec_f32",
            torch.float64: "ba_band_matvec_f64"}[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def band_matvec(band, x):
    """y = S x (P*D,) for the band (P, B, D, D) and x (P*D,), one launch
    of the CUDA kernel."""
    if not (band.is_cuda and x.is_cuda and band.device == x.device):
        raise ValueError("band_matvec kernel: band and x must be on one CUDA "
                         "device")
    if band.dtype not in (torch.float32, torch.float64) \
            or x.dtype != band.dtype:
        raise TypeError(f"band_matvec kernel: unsupported dtypes "
                        f"{band.dtype}, {x.dtype}")
    if band.dim() != 4 or band.shape[2] != band.shape[3]:
        raise ValueError(f"band_matvec kernel: band must be (P, B, D, D), "
                         f"not {tuple(band.shape)}")
    P, B, D, _ = band.shape
    if not 1 <= D <= 32 or B < 1:
        raise ValueError(f"band_matvec kernel: needs 1 <= D <= 32 and B >= 1 "
                         f"(D = {D}, B = {B})")
    if x.shape != (P * D,):
        raise ValueError(f"band_matvec kernel: x must be ({P * D},), not "
                         f"{tuple(x.shape)}")
    band = band.contiguous()
    x = x.contiguous()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(band.device).cuda_stream
    chb, nw = schedule(B)
    rc = _fn(band.dtype)(band.data_ptr(), x.data_ptr(), P, B, D, chb, nw,
                         y.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"band_matvec kernel launch failed: CUDA error "
                           f"{rc}")
    band_matvec.launches += 1
    return y


band_matvec.launches = 0
