"""Kernel 6: the projection family's share of the matrix-free Schur product
(CUDA).

Replaces the TPU formulation `ba_tpu/solver/cg.py:s_matvec` (:160) with
its applies `_u_apply` (:123), `_wt_apply` (:103) and `_w_apply` (:111):
per-row einsums, a segment sum by landmark (W^T x), a gather of
z = V^-1 W^T x back to the rows, and segment sums by pose, each through
device memory.  It runs once per PCG iteration of the matrix-free solver
(`solver/cg.py:solve_reduced_cg`, up to `cg_max_iterations` per build).

Design (csrc/schur_matvec.cu): one warp per landmark over the landmark CSR
of the block plan (`BlockPlan.V`, built once per solve).  Each warp forms
u_n = J_m x + J_r x of its rows, sums j_l^T u_n in a fixed order (no
atomics), takes z_l = V_l^-1 of the sum, and writes J_m^T w_n and J_r^T w_n
with w_n = u_n - j_l z_l: the first 2 Nr rows of the block plan's rhs
order, which segsum then sums by pose with the other families' rows.
U x and -W V^-1 W^T x of the projection family are one pass; W^T x never
goes to device memory.  Bit-identical from launch to launch.

`schur_matvec_plain` is its plain PyTorch version (the CPU path of
`solver/cg.py` takes it).

Bound on an H100: bytes (~14 MB at the long CG configuration, 85,823 rows
in f32: ~4.2 us at 3.35 TB/s).

Scope: inverse-depth landmarks (lm_size 1), pose width D >= 6, float32 and
float64.  Other landmark sizes raise on the card (ROADMAP.md queue 1, the
kernel variants).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I, _I, _I, _P, _P]


def schur_matvec_plain(j_m, j_r, j_l, pose, ref, lm, vinv, x, D: int):
    """The rows kernel 6 writes, (2 Nr, 6): [J_m^T w; J_r^T w] with
    w = u - j_l V^-1 (sum by landmark of j_l^T u), u = J_m x[pose] +
    J_r x[ref]; x (P * D,), vinv (L, lm, lm)."""
    X = x.reshape(-1, D)[:, :6]
    u = (torch.einsum("nik,nk->ni", j_m, X[pose])
         + torch.einsum("nik,nk->ni", j_r, X[ref]))
    lm = lm.long()
    wt = u.new_zeros(vinv.shape[:2]).index_add_(
        0, lm, torch.einsum("nil,ni->nl", j_l, u))
    z = torch.einsum("lij,lj->li", vinv, wt)
    w = u - torch.einsum("nil,nl->ni", j_l, z[lm])
    return torch.cat([torch.einsum("nik,ni->nk", j_m, w),
                      torch.einsum("nik,ni->nk", j_r, w)])


def _fn(dtype):
    lib = build.load("schur_matvec")
    name = {torch.float32: "ba_schur_matvec_f32",
            torch.float64: "ba_schur_matvec_f64"}[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def schur_matvec(j_m, j_r, j_l, pose, ref, vinv, x, perm, offsets, D: int,
                 out=None):
    """The rows of `schur_matvec_plain`, (2 Nr, 6), from one launch of the
    CUDA kernel.  `perm`/`offsets` are the landmark CSR of the rows (a
    `segsum.SegPlan` of the ids proj.lm); `pose`/`ref` int32 (Nr,), the
    block plan's `pose_ref`; `out`, when given, is a contiguous (2 Nr, 6)
    tensor the rows are written into."""
    Nr = j_m.shape[0]
    L = vinv.shape[0]
    floats = (j_m, j_r, j_l, vinv, x)
    if not all(t.is_cuda and t.device == x.device
               for t in floats + (pose, ref, perm, offsets)):
        raise ValueError("schur_matvec kernel: all tensors must be on one "
                         "CUDA device")
    if x.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != x.dtype for t in floats):
        raise TypeError("schur_matvec kernel: unsupported dtypes "
                        f"{[t.dtype for t in floats]}")
    if j_l.shape[1:] != (2, 1) or vinv.shape[1:] != (1, 1):
        raise NotImplementedError(
            "schur_matvec kernel covers inverse-depth landmarks (lm_size 1): "
            f"j_l {tuple(j_l.shape)}, vinv {tuple(vinv.shape)} (ROADMAP.md "
            "queue 1, the kernel variants)")
    if j_m.shape != (Nr, 2, 6) or j_r.shape != (Nr, 2, 6) \
            or j_l.shape[0] != Nr:
        raise ValueError("schur_matvec kernel: J_m, J_r must be (Nr, 2, 6) "
                         "and j_l (Nr, 2, 1)")
    if pose.dtype != torch.int32 or ref.dtype != torch.int32 \
            or pose.shape != (Nr,) or ref.shape != (Nr,):
        raise ValueError("schur_matvec kernel: pose and ref must be int32 "
                         "(Nr,)")
    if perm.dtype != torch.int32 or offsets.dtype != torch.int32 \
            or perm.shape != (Nr,) or offsets.shape != (L + 1,):
        raise ValueError("schur_matvec kernel: the landmark CSR was built "
                         "for another row or landmark count")
    if D < 6 or x.dim() != 1 or x.shape[0] % D:
        raise ValueError(f"schur_matvec kernel: x must be (P * {D},)")
    if out is None:
        out = torch.empty((2 * Nr, 6), dtype=x.dtype, device=x.device)
    elif out.shape != (2 * Nr, 6) or out.dtype != x.dtype \
            or out.device != x.device or not out.is_contiguous():
        raise ValueError("schur_matvec kernel: out must be a contiguous "
                         f"({2 * Nr}, 6) tensor")
    args = [t.contiguous() for t in (j_m, j_r, j_l, pose, ref, vinv, x,
                                     perm, offsets)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn(x.dtype)(*[t.data_ptr() for t in args], L, Nr, D,
                      out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"schur_matvec kernel launch failed: CUDA error "
                           f"{rc}")
    schur_matvec.launches += 1
    return out


schur_matvec.launches = 0
