"""Kernel 2: deterministic segmented block sum (CUDA).

Replaces the TPU formulation `ba_tpu/solver/assemble.py:seg_sum_blocks`
(:120-156): a one-hot MXU matmul below 512 segments and a serialized
scatter above.  It carries the seven normal-equation accumulations of a
banded build (the band grid, the pose rhs, the IMU grid and rhs, V, rhs_l
and the W blocks).

Design (csrc/segsum.cu): the wrapper sorts the ids stably and takes CSR
offsets (`segment_csr`, index preparation in PyTorch); the kernel gives one
warp per segment and each lane owns columns of the flattened block, adding
the segment's rows in sorted order.  The sum order is fixed, so the output
is bit-identical from run to run — an atomics-ordered f32 sum would make
the accept/reject at the f32 cost floor wobble between runs.  Rows whose id
is < 0 or >= nseg sort past the last offset and are dropped, as
`jax.ops.segment_sum` and the one-hot form drop them.

Bound on an H100: bytes — each input row is read once and each output
written once (a few MB per build), against 3.35 TB/s; the adds are
negligible.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _P, _P]


def _fn(dtype):
    lib = build.load("segsum")
    name = {torch.float32: "ba_segsum_f32",
            torch.float64: "ba_segsum_f64"}[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def segment_csr(ids, nseg: int):
    """(perm, offsets): a stable sort of the rows by id, and offsets
    (nseg + 1,) so segment s owns perm[offsets[s]:offsets[s+1]].
    Out-of-range ids are keyed past the last segment."""
    ids = ids.long()
    key = torch.where((ids >= 0) & (ids < nseg), ids, nseg)
    sorted_key, perm = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        sorted_key, torch.arange(nseg + 1, device=ids.device))
    return perm, offsets


def seg_sum(vals, ids, nseg: int):
    """out[s] = sum of vals[i] over rows with ids[i] == s, (nseg, k), from
    the CUDA kernel.  `vals` is a contiguous (n, k) float32/float64 CUDA
    tensor, `ids` (n,) integer."""
    if not (vals.is_cuda and ids.is_cuda and vals.device == ids.device):
        raise ValueError("segsum kernel: vals and ids must be on one CUDA "
                         "device")
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segsum kernel: unsupported dtype {vals.dtype}")
    if vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError("segsum kernel: vals must be contiguous (n, k)")
    if ids.dim() != 1 or ids.shape[0] != vals.shape[0]:
        raise ValueError("segsum kernel: ids must be (n,) matching vals")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise TypeError("segsum kernel: ids must be integer")
    n, k = vals.shape
    out = torch.empty((nseg, k), dtype=vals.dtype, device=vals.device)
    if nseg == 0 or k == 0:
        return out.zero_()
    perm, offsets = segment_csr(ids, nseg)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    rc = _fn(vals.dtype)(vals.data_ptr(), perm.data_ptr(),
                         offsets.data_ptr(), nseg, k, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed: CUDA error {rc}")
    seg_sum.launches += 1
    return out


seg_sum.launches = 0
