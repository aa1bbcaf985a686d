"""Kernel 10: the per-window Schur system of a fused fleet (CUDA).

Replaces the parts of the TPU formulation
`ba_tpu/solver/banded.py:solve_reduced_fleet_dense` (:498-598) that are
neither a matrix product nor a factorization: the strip scatter of the
projection rows into a zeroed W_T (:550-565), the product with V^-1, the
vmapped `band_to_dense` of each window's U (:531-542) and the Jacobi
scaling (:574-578).  The batched Schur product C = (V^-1 W)_T^T W_T stays
`torch.bmm` and the batched Cholesky `torch.linalg`, as ba_tpu leaves them
to XLA (`solver/banded.py:solve_reduced_fleet_dense`).

Two launches per build, each with its own count:

  fleet_w         (a) W_T and (V^-1 W)_T, (F, L_w lm, n_w), from the unique
                  W blocks of the build on a `fleet_plan` table built once
                  per solve: one thread per output element, one writer each,
                  zeros written in the same pass, padding blocks dropped.
  fleet_epilogue  (b) Ss = diag(s) (U_f - C) diag(s) + eps I and s =
                  rsqrt(max(diag(U_f - C), 1e-12)), (F, n_w, n_w) and
                  (F, n_w), with U_f densified from the families-only band on
                  the fly, in one pass.

`fleet_w_plain` and `fleet_epilogue_plain` are the plain PyTorch versions
(the CPU path of `solver/banded.py` takes them).

Bound on an H100: bytes.  At the fleet of four flagship windows (F = 4,
n_w = 1,152, L_w = 497, f32): (a) ~20 MB, ~5.8 us; (b) ~46 MB, ~14 us at
3.35 TB/s (csrc/fleet_schur.cu).  Float32 and float64, any landmark size,
D >= 6.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_W_ARGTYPES = [_P, _P, _P] + [_I] * 5 + [_P, _P, _P]
_E_ARGTYPES = [_P, _P] + [_I] * 4 + [ctypes.c_double, _P, _P, _P]


def _window_ids(wb_pose, wb_lm, P: int, L: int, F: int):
    """(landmark, local pose, kept) of every W block of a fused fleet: a
    block is kept when its landmark is real (< L) and its pose lies in its
    landmark's window."""
    P_w, L_w = P // F, L // F
    wl, wp = wb_lm.long(), wb_pose.long()
    kept = (wl < L) & (wp // P_w == wl // max(L_w, 1))
    return wl, wp - (wl // max(L_w, 1)) * P_w, kept


def fleet_plan(wb_pose, wb_lm, P: int, L: int, F: int):
    """(L * P_w,) int32: the W block of (landmark l, local pose p), or -1,
    on the tables' device, with no host read.  Build it once per solve."""
    P_w = P // F
    wl, pl, kept = _window_ids(wb_pose, wb_lm, P, L, F)
    n = L * P_w
    table = torch.full((n + 1,), -1, dtype=torch.int32, device=wb_pose.device)
    rows = torch.arange(wb_pose.shape[0], dtype=torch.int32,
                        device=wb_pose.device)
    return table.index_put((torch.where(kept, wl * P_w + pl, n),),
                           rows)[:n].contiguous()


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


def _fn(name, dtype, argtypes):
    lib = build.load("fleet_schur")
    fn = getattr(lib, f"ba_fleet_{name}_"
                 + {torch.float32: "f32", torch.float64: "f64"}[dtype])
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _floats(what, *ts):
    t0 = ts[0]
    if not all(t.is_cuda and t.device == t0.device for t in ts):
        raise ValueError(f"{what} kernel: all tensors must be on one CUDA "
                         "device")
    if t0.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != t0.dtype for t in ts):
        raise TypeError(f"{what} kernel: unsupported dtypes "
                        f"{[t.dtype for t in ts]}")


def fleet_w(wb, vinv, block_of, F: int, D: int):
    """The (W_T, WVi_T) of `fleet_w_plain` from one launch of kernel 10
    (a); `block_of` is the solve's `fleet_plan`."""
    _floats("fleet_w", wb, vinv)
    L, lm, _ = vinv.shape
    if wb.dim() != 3 or wb.shape[1:] != (6, lm) or vinv.shape[2] != lm:
        raise ValueError(f"fleet_w kernel: W blocks {tuple(wb.shape)} and "
                         f"V^-1 {tuple(vinv.shape)} do not match")
    if F < 1 or L % F or D < 6:
        raise ValueError(f"fleet_w kernel: {L} landmarks in {F} windows, "
                         f"D = {D}")
    if block_of.device != wb.device or block_of.dtype != torch.int32 \
            or block_of.dim() != 1 or block_of.shape[0] % max(L, 1):
        raise ValueError("fleet_w kernel: the plan was built for another "
                         "fleet")
    P_w = block_of.shape[0] // L if L else 0
    shape = (F, (L // F) * lm, P_w * D)
    wt = torch.empty(shape, dtype=wb.dtype, device=wb.device)
    wvit = torch.empty_like(wt)
    args = [t.contiguous() for t in (wb, vinv, block_of)]
    stream = torch.cuda.current_stream(wb.device).cuda_stream
    rc = _fn("w", wb.dtype, _W_ARGTYPES)(
        *[t.data_ptr() for t in args], F, L // F, max(P_w, 1), D, lm,
        wt.data_ptr(), wvit.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fleet_w kernel launch failed: CUDA error {rc}")
    fleet_w.launches += 1
    return wt, wvit


fleet_w.launches = 0


def fleet_epilogue(band, C, F: int, eps: float):
    """The (Ss, scal) of `fleet_epilogue_plain` from one launch of kernel
    10 (b)."""
    _floats("fleet_epilogue", band, C)
    if band.dim() != 4 or band.shape[2] != band.shape[3]:
        raise ValueError(f"fleet_epilogue kernel: band must be (P, B, D, D),"
                         f" not {tuple(band.shape)}")
    P, B, D, _ = band.shape
    if F < 1 or P % F:
        raise ValueError(f"fleet_epilogue kernel: {P} poses in {F} windows")
    n_w = (P // F) * D
    if C.shape != (F, n_w, n_w):
        raise ValueError(f"fleet_epilogue kernel: C must be ({F}, {n_w}, "
                         f"{n_w}), not {tuple(C.shape)}")
    Ss = torch.empty_like(C)
    scal = torch.empty((F, n_w), dtype=C.dtype, device=C.device)
    band, C = band.contiguous(), C.contiguous()
    stream = torch.cuda.current_stream(C.device).cuda_stream
    rc = _fn("epilogue", C.dtype, _E_ARGTYPES)(
        band.data_ptr(), C.data_ptr(), F, P // F, B, D, float(eps),
        Ss.data_ptr(), scal.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fleet_epilogue kernel launch failed: CUDA error "
                           f"{rc}")
    fleet_epilogue.launches += 1
    return Ss, scal


fleet_epilogue.launches = 0
