"""K5b: the dense symmetric matrix of a block band (CUDA).

Replaces the TPU formulation `ba_tpu/solver/assemble.py:band_to_dense`
(:159-184), a pad and flat-reshape placement of the band strips followed by
`upper + upper^T - diagonal strips`.  It runs once per dense build on the
banded grid (`solver/assemble.py`: the flagship, the GPS smoother's batch)
and once per `schur_on_band` solve (`solver/banded.py:band_to_dense_sym`).
The fused fleet densifies its windows inside kernel 10 instead.

Design (csrc/band_to_dense.cu): one block per (block row, column stripe);
the blocks of the row that meet the stripe staged in shared memory by
scalar loads of consecutive threads, a lower block transposed on its
shared-memory read; 16-byte stores of the block row's D output rows, zeros
past the band written with no load; D a compile-time constant for 6, 9 and
15 (any other D reads the band in place, unstaged).  A diagonal block
rounds as (u + u^T) - u, the plain version's order, so the kernel's output
equals the plain version's element for element.

`solver/assemble.py:band_to_dense_plain` is its plain PyTorch version;
`assemble.band_to_dense` takes it for CPU tensors.

Bound on an H100: bytes (the band read once, the dense matrix written once:
6.3 MB at the flagship in f32, ~1.9 us at 3.35 TB/s; 116.6 MB at the GPS
batch's P = 600, B = 2, ~35 us).

Scope: float32 and float64, any P, B >= 1, D.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _I, _I, _I, _P, _P]


def _fn(dtype):
    lib = build.load("band_to_dense")
    name = {torch.float32: "ba_band_to_dense_f32",
            torch.float64: "ba_band_to_dense_f64"}[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def band_to_dense(band):
    """The dense symmetric (P*D, P*D) matrix of the band (P, B, D, D), one
    launch of the CUDA kernel."""
    if not band.is_cuda:
        raise ValueError("band_to_dense kernel: the band must be on a CUDA "
                         "device")
    if band.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"band_to_dense kernel: unsupported dtype "
                        f"{band.dtype}")
    if band.dim() != 4 or band.shape[2] != band.shape[3] or band.shape[1] < 1:
        raise ValueError(f"band_to_dense kernel: band must be (P, B, D, D) "
                         f"with B >= 1, not {tuple(band.shape)}")
    P, B, D, _ = band.shape
    band = band.contiguous()
    out = torch.empty((P * D, P * D), dtype=band.dtype, device=band.device)
    stream = torch.cuda.current_stream(band.device).cuda_stream
    rc = _fn(band.dtype)(band.data_ptr(), P, B, D, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"band_to_dense kernel launch failed: CUDA error "
                           f"{rc}")
    band_to_dense.launches += 1
    return out


band_to_dense.launches = 0
