"""Kernel 10: the scaled per-window Schur system of a fused fleet (CUDA).

Replaces the TPU formulation `ba_tpu/solver/banded.py:
solve_reduced_fleet_dense` (:498-598) up to the factorization: the strip
scatter of the projection rows into a zeroed W_T (:550-565), the product
with V^-1, the batched Schur product C = (V^-1 W)_T^T W_T, the vmapped
`band_to_dense` of each window's U (:531-542) and the Jacobi scaling
(:574-578).  The batched Cholesky stays `torch.linalg`, as ba_tpu leaves it
to XLA.

`fleet_schur` computes (Ss, scal) straight from the build's W blocks, the
landmark inverses, the families-only band and a `fleet_plan` table built
once per solve, in two launches (csrc/fleet_schur.cu): a prep pass (each
32-row range's landmark bitmask, and each row's diagonal and scaling), then
one block per 64 x 64 lower tile of each window that walks only the
landmarks its rows and columns share.  No dense W_T, (V^-1 W)_T or C is
formed and no `bmm` runs.  `fleet_schur_plain` is the plain PyTorch version
(the CPU path of `solver/banded.py`): the dense operands (`fleet_w_plain`),
`torch.bmm`, and the epilogue (`fleet_epilogue_plain`).

Bound on an H100: bytes.  At the fleet of four flagship windows (F = 4,
n_w = 1,152, L_w = 497, f32): the band 4 MB, the W blocks and the table
~2 MB, and Ss 21.2 MB, ~8 us at 3.35 TB/s.  Float32 and float64, lm 0, 1
and 3, D >= 6, any F that divides P and L.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 6 + [ctypes.c_double] + [_P] * 4


def _window_ids(wb_pose, wb_lm, P: int, L: int, F: int):
    """(landmark, local pose, kept) of every W block of a fused fleet: a
    block is kept when its landmark is real (< L) and its pose lies in its
    landmark's window."""
    P_w, L_w = P // F, L // F
    wl, wp = wb_lm.long(), wb_pose.long()
    kept = (wl < L) & (wp // P_w == wl // max(L_w, 1))
    return wl, wp - (wl // max(L_w, 1)) * P_w, kept


def fleet_plan(wb_pose, wb_lm, P: int, L: int, F: int):
    """(P, L / F) int32: the W block of (pose p, its window's landmark l),
    or -1, on the tables' device, with no host read.  Build it once per
    solve."""
    L_w = L // F
    wl, _, kept = _window_ids(wb_pose, wb_lm, P, L, F)
    n = P * L_w
    table = torch.full((n + 1,), -1, dtype=torch.int32, device=wb_pose.device)
    rows = torch.arange(wb_pose.shape[0], dtype=torch.int32,
                        device=wb_pose.device)
    cell = wb_pose.long() * L_w + wl % max(L_w, 1)
    return table.index_put((torch.where(kept, cell, n),),
                           rows)[:n].reshape(P, L_w).contiguous()


def fleet_w_plain(wb, vinv, wb_pose, wb_lm, F: int, P: int, D: int):
    """(W_T, WVi_T), (F, L_w lm, P_w D): W_T[f, l lm + a, p D + c] =
    Wb_{p,l}[c, a] for c < 6, WVi_T = V^-1 W_T per landmark, zero
    elsewhere."""
    L, lm, _ = vinv.shape
    P_w = P // F
    wl, pl, kept = _window_ids(wb_pose, wb_lm, P, L, F)
    W = wb.new_zeros((L, lm, P_w, D))
    W[wl[kept], :, pl[kept], :6] = wb[kept].transpose(1, 2)
    WV = torch.einsum("lam,lmpc->lapc", vinv, W)
    shape = (F, (L // F) * lm, P_w * D)
    return W.reshape(shape), WV.reshape(shape)


def fleet_epilogue_plain(band, C, F: int, eps: float):
    """(Ss, scal): S = U_f - C per window, U_f the window's block of the
    band (P, B, D, D) densified, scal = rsqrt(max(diag S, 1e-12)),
    Ss = S scal_i scal_j + eps I."""
    from ..solver.assemble import band_to_dense_plain

    P, B, D, _ = band.shape
    U = torch.stack([band_to_dense_plain(b)
                     for b in band.reshape(F, P // F, B, D, D)])
    S = U - C
    scal = torch.rsqrt(torch.clamp(torch.diagonal(S, dim1=-2, dim2=-1),
                                   min=1e-12))
    Ss = S * scal[:, :, None] * scal[:, None, :]
    return Ss + eps * torch.eye(S.shape[-1], dtype=S.dtype,
                                device=S.device), scal


def fleet_schur_plain(wb, vinv, wb_pose, wb_lm, band, F: int, eps: float):
    """The plain version of `fleet_schur`: (Ss (F, n_w, n_w), scal (F,
    n_w)) from the dense per-window operands and one batched product."""
    P, _, D, _ = band.shape
    W_T, WVi_T = fleet_w_plain(wb, vinv, wb_pose, wb_lm, F, P, D)
    return fleet_epilogue_plain(band, torch.bmm(WVi_T.mT, W_T), F, eps)


def _fn(dtype):
    lib = build.load("fleet_schur")
    fn = getattr(lib, "ba_fleet_schur_"
                 + {torch.float32: "f32", torch.float64: "f64"}[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def fleet_schur(wb, vinv, table, band, F: int, eps: float):
    """The (Ss, scal) of `fleet_schur_plain` from kernel 10's two launches;
    `table` is the solve's `fleet_plan`."""
    ts = (wb, vinv, band)
    dev = band.device
    if not all(t.is_cuda and t.device == dev for t in ts + (table,)):
        raise ValueError("fleet_schur kernel: all tensors must be on one "
                         "CUDA device")
    dtype = band.dtype
    if dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != dtype for t in ts):
        raise TypeError(f"fleet_schur kernel: unsupported dtypes "
                        f"{[t.dtype for t in ts]}")
    if band.dim() != 4 or band.shape[2] != band.shape[3]:
        raise ValueError(f"fleet_schur kernel: band must be (P, B, D, D), "
                         f"not {tuple(band.shape)}")
    P, B, D, _ = band.shape
    L, lm = vinv.shape[0], vinv.shape[1] if vinv.dim() == 3 else -1
    if vinv.dim() != 3 or vinv.shape[2] != lm or lm not in (0, 1, 3) \
            or wb.dim() != 3 or wb.shape[1:] != (6, lm):
        raise ValueError(f"fleet_schur kernel: W blocks {tuple(wb.shape)} "
                         f"and V^-1 {tuple(vinv.shape)} do not match")
    if F < 1 or P % F or L % F or D < 6:
        raise ValueError(f"fleet_schur kernel: {P} poses and {L} landmarks "
                         f"in {F} windows, D = {D}")
    L_w = L // F
    if table.dtype != torch.int32 or tuple(table.shape) != (P, L_w):
        raise ValueError("fleet_schur kernel: the plan was built for another "
                         "fleet")
    P_w, n_w = P // F, (P // F) * D
    Ss = torch.empty((F, n_w, n_w), dtype=dtype, device=dev)
    scal = torch.empty((F, n_w), dtype=dtype, device=dev)
    words = F * -(-n_w // 32) * -(-L_w // 32) if lm else 1
    mask = torch.empty((max(words, 1),), dtype=torch.int32, device=dev)
    args = [t.contiguous() for t in (wb, vinv, table, band)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn(dtype)(*[t.data_ptr() for t in args], F, P_w, L_w, D, lm, B,
                    float(eps), mask.data_ptr(), scal.data_ptr(),
                    Ss.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fleet_schur kernel launch failed: CUDA error "
                           f"{rc}")
    fleet_schur.launches += 1
    return Ss, scal


fleet_schur.launches = 0
