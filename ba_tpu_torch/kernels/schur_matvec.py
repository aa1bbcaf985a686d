"""Kernel 6: the projection family's share of the matrix-free Schur product
(CUDA).

Replaces the TPU formulation `ba_tpu/solver/cg.py:s_matvec` (:160) with
its applies `_u_apply` (:123), `_wt_apply` (:103) and `_w_apply` (:111):
per-row einsums, a segment sum by landmark (W^T x), a gather of
z = V^-1 W^T x back to the rows, and segment sums by pose, each through
device memory.  It runs once per PCG iteration of the matrix-free solver
(`solver/cg.py:pcg_solve`, up to `cg_max_iterations` per build).

Design (csrc/schur_matvec.cu): rows, not landmarks, are the unit of work.
A `SchurPlan`, built once per solve with no host read, sorts the rows by
landmark (the block plan's V order) and cuts them into tiles of whole
landmarks; `schur_pack`, once per build, copies the row blocks into that
order as 16-byte-aligned records [J_m | J_r | j_l | J_c | pad];
`schur_matvec` then reads each record once (16-byte loads), keeps
u_n = J_m x + J_r x + J_c x_k in a register, sums j_l^T u_n by landmark in
row order (no atomics, so two launches are bit-identical), takes
z_l = V_l^-1 of the sum and writes [J_m^T w_n, J_r^T w_n],
w_n = u_n - j_l z_l, for row n of the sorted order (16-byte stores).
Segsum sums those rows by pose on the block plan's `s_rhs` (the plan's
`out_pose`, then the unary and binary rows).  With a calibration block
(K columns, x_k = x's last K values) each tile also writes its sum of
J_c^T w_n in a fixed order, (n_tiles, K), which segsum adds in tile order
(`BlockPlan.cal`): ba_tpu's `_u_apply` :137-138 and `_w_apply` :117-120.
Landmark sizes 0 (w_n = u_n), 1 and 3; K = 0, 5, 6 or 11 (the
calibration widths kernel 1 covers); float32 and float64.

Plain versions: `schur_matvec_plain` (row order, summed by landmark with
`index_add_`) is the CPU path of `solver/cg.py`; `schur_pack_plain` and
`schur_matvec_sorted_plain` compute the kernels' outputs in their order
(the tests and chip_smoke.py hold the kernels against them).

Bound on an H100: bytes (~14.1 MB a product at the PCG configuration,
85,823 rows in f32, counting the 24 + 2 lm values and 3 ids a row needs:
~4.2 us at 3.35 TB/s; the padded records and int4 ids the route reads
come to ~15.2 MB; with K = 11 the 22 values of J_c more, ~21.7 MB).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .segsum import segment_csr

ROWS, H = 256, 224   # csrc/schur_matvec.cu: threads a block, tile window
LM_SIZES = (0, 1, 3)
CALIB_DIMS = (0, 5, 6, 11)   # calib_size 0 or 5, with or without T_vs

_P = ctypes.c_void_p
_I = ctypes.c_int
_PACK_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _I, _P, _P]
_ARGTYPES = [_I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P]


class SchurPlan(NamedTuple):
    """The static row order of the kernels, built once per solve."""

    perm: torch.Tensor    # (Nr,) int32: the rows stably sorted by landmark,
    #                       out-of-range landmark ids last
    ids: torch.Tensor     # (Nr, 4) int32 per sorted row: pose, ref, group
    #                       (a landmark's rows, or one row whose landmark
    #                       is out of range), landmark (-1 out of range)
    tiles: torch.Tensor   # (ceil(Nr / H) + 1,) int32: tile t is rows
    #                       [tiles[t], tiles[t + 1]), the groups that start
    #                       in rows [t H, (t + 1) H)
    out_pose: torch.Tensor  # (2 Nr,) int64: the pose each output row of
    #                         `schur_matvec` (flattened (Nr, 2, 6) to
    #                         (2 Nr, 6)) is summed into


class SchurPack(NamedTuple):
    """The row blocks of one build in the plan's order."""

    rows: torch.Tensor    # (Nr, record_width(lm, dtype, K))
    lm: int
    K: int = 0            # calibration columns


def schur_plan(pose, ref, lm, L: int, perm=None) -> SchurPlan:
    """The plan of rows with ids pose, ref, lm (Nr,) over L landmarks, on
    their device, with no host read; `perm`, when given, is the stable
    landmark sort of the rows (a `segsum.SegPlan` of lm's)."""
    lm = lm.long()
    dev = lm.device
    if perm is None:
        perm = segment_csr(lm, L)[0]
    perm = perm.long()
    key = torch.where((lm >= 0) & (lm < L), lm, L)[perm]
    Nr = key.shape[0]
    r = torch.arange(Nr, device=dev)
    start = (r == 0) | (key != torch.roll(key, 1)) | (key == L)
    group = torch.cumsum(start, 0) - 1
    # the first group start at or past each row: a reverse running minimum
    nxt = torch.where(start, r, Nr)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values, [0])
    t = torch.arange(-(-Nr // H), device=dev) * H
    tiles = torch.cat([nxt[t], torch.full((1,), Nr, device=dev)])
    ids = torch.stack([pose.long()[perm], ref.long()[perm], group,
                       torch.where(key < L, key, -1)], dim=1)
    return SchurPlan(perm.int(), ids.int().contiguous(), tiles.int(),
                     ids[:, :2].reshape(-1))


def record_width(lm: int, dtype, K: int = 0) -> int:
    """Values of a packed record: J_m, J_r (24), j_l (2 lm), J_c (2 K),
    padded to a multiple of 16 bytes."""
    u = 16 // dtype.itemsize
    return -(-(24 + 2 * lm + 2 * K) // u) * u


def schur_pack_plain(j_m, j_r, j_l, plan: SchurPlan, lm: int,
                     j_c=None) -> SchurPack:
    """The records of `schur_pack`: [J_m | J_r | j_l | J_c | 0] of each row
    in the plan's order; j_c (Nr, 2, K) or None (K = 0)."""
    Nr = j_m.shape[0]
    K = 0 if j_c is None else j_c.shape[2]
    cols = [j_m.reshape(Nr, 12), j_r.reshape(Nr, 12)]
    if lm:
        cols.append(j_l.reshape(Nr, 2 * lm))
    if K:
        cols.append(j_c.reshape(Nr, 2 * K))
    rows = torch.cat(cols, dim=1)
    rows = torch.nn.functional.pad(
        rows, (0, record_width(lm, j_m.dtype, K) - rows.shape[1]))
    return SchurPack(rows[plan.perm.long()], lm, K)


def schur_matvec_plain(j_m, j_r, j_l, pose, ref, lm, vinv, x, D: int,
                       j_c=None, xk=None):
    """The projection rows of the Schur product in row order, (2 Nr, 6):
    [J_m^T w; J_r^T w] with w = u - j_l V^-1 (sum by landmark of j_l^T u),
    u = J_m x[pose] + J_r x[ref] (+ J_c x_k); x (P * D,), vinv (L, lm, lm).
    With the calibration columns j_c (Nr, 2, K) and x_k (K,), returns
    (rows, sum of J_c^T w (K,))."""
    X = x.reshape(-1, D)[:, :6]
    u = (torch.einsum("nik,nk->ni", j_m, X[pose])
         + torch.einsum("nik,nk->ni", j_r, X[ref]))
    if j_c is not None:
        u = u + torch.einsum("nik,k->ni", j_c, xk)
    lm = lm.long()
    wt = u.new_zeros(vinv.shape[:2]).index_add_(
        0, lm, torch.einsum("nil,ni->nl", j_l, u))
    z = torch.einsum("lij,lj->li", vinv, wt)
    w = u - torch.einsum("nil,nl->ni", j_l, z[lm])
    rows = torch.cat([torch.einsum("nik,ni->nk", j_m, w),
                      torch.einsum("nik,ni->nk", j_r, w)])
    if j_c is None:
        return rows
    return rows, torch.einsum("nik,ni->k", j_c, w)


def _tile_of_rows(plan: SchurPlan):
    """The tile of each row of the plan's order."""
    rows = torch.arange(plan.ids.shape[0], device=plan.tiles.device)
    return torch.searchsorted(plan.tiles[1:].long(), rows, right=True)


def schur_matvec_sorted_plain(pack: SchurPack, plan: SchurPlan, vinv, x,
                              D: int, xk=None):
    """The rows `schur_matvec` writes, (Nr, 2, 6), in its order: row i of
    the plan's order, each landmark's j_l^T u summed over its rows first to
    last.  With a calibration block (pack.K > 0, x_k (K,)), returns (rows,
    each tile's sum of J_c^T w (n_tiles, K)).  Reads the longest group's
    length from the device."""
    W, lm, K = pack
    Nr = W.shape[0]
    jm = W[:, :12].reshape(Nr, 2, 6)
    jr = W[:, 12:24].reshape(Nr, 2, 6)
    jc0 = 24 + 2 * lm
    jc = W[:, jc0: jc0 + 2 * K].reshape(Nr, 2, K)
    pose, ref, group, lmid = plan.ids.long().unbind(1)
    X = x.reshape(-1, D)[:, :6]
    u = (torch.einsum("nik,nk->ni", jm, X[pose])
         + torch.einsum("nik,nk->ni", jr, X[ref]))
    if K:
        u = u + torch.einsum("nik,k->ni", jc, xk)
    w = u
    if lm and Nr:
        jl = W[:, 24:24 + 2 * lm].reshape(Nr, 2, lm)
        t = torch.einsum("nil,ni->nl", jl, u)
        G = int(group[-1]) + 1
        first = torch.zeros(G, dtype=torch.long, device=W.device)
        first.scatter_reduce_(0, group, torch.arange(Nr, device=W.device),
                              "amin", include_self=False)
        count = torch.bincount(group, minlength=G)
        acc = t.new_zeros((G, lm))
        for j in range(int(count.max())):
            row = torch.clamp(first + j, max=Nr - 1)
            acc = acc + torch.where((j < count)[:, None], t[row], 0.0)
        glm = lmid[first]
        z = torch.einsum("gij,gj->gi", vinv[glm.clamp(min=0)], acc)
        z = torch.where((glm >= 0)[:, None], z, 0.0)
        w = u - torch.einsum("nil,nl->ni", jl, z[group])
    rows = torch.stack([torch.einsum("nik,ni->nk", jm, w),
                        torch.einsum("nik,ni->nk", jr, w)], dim=1)
    if not K:
        return rows
    partial = W.new_zeros((plan.tiles.shape[0] - 1, K)).index_add_(
        0, _tile_of_rows(plan), torch.einsum("nik,ni->nk", jc, w))
    return rows, partial


def _fn(name, dtype, argtypes):
    lib = build.load("schur_matvec")
    suffix = {torch.float32: "_f32", torch.float64: "_f64"}[dtype]
    fn = getattr(lib, name + suffix)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _aligned(t):
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _check_lm(lm, K=0):
    if lm not in LM_SIZES:
        raise NotImplementedError(
            f"schur_matvec kernel covers landmark sizes {LM_SIZES}, not {lm}")
    if K not in CALIB_DIMS:
        raise NotImplementedError(
            f"schur_matvec kernel covers calibration blocks of {CALIB_DIMS} "
            f"columns, not {K}")


def schur_pack(j_m, j_r, j_l, plan: SchurPlan, lm: int,
               j_c=None) -> SchurPack:
    """The records of `schur_pack_plain` from one launch of the pack
    kernel: j_m, j_r (Nr, 2, 6), for lm > 0 j_l (Nr, 2, lm) and, with a
    calibration block, j_c (Nr, 2, K) in row order, on one CUDA device."""
    K = 0 if j_c is None else j_c.shape[-1]
    _check_lm(lm, K)
    Nr = j_m.shape[0]
    floats = (j_m, j_r) + ((j_l,) if lm else ()) + ((j_c,) if K else ())
    if not all(t.is_cuda and t.device == j_m.device
               for t in floats + (plan.perm,)):
        raise ValueError("schur_pack kernel: all tensors must be on one "
                         "CUDA device")
    if j_m.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != j_m.dtype for t in floats):
        raise TypeError("schur_pack kernel: unsupported dtypes "
                        f"{[t.dtype for t in floats]}")
    if j_m.shape != (Nr, 2, 6) or j_r.shape != (Nr, 2, 6) \
            or (lm and j_l.shape != (Nr, 2, lm)) \
            or (K and j_c.shape != (Nr, 2, K)):
        raise ValueError(f"schur_pack kernel: J_m, J_r must be (Nr, 2, 6), "
                         f"j_l (Nr, 2, {lm}) and J_c (Nr, 2, {K})")
    if plan.perm.dtype != torch.int32 or plan.perm.shape != (Nr,):
        raise ValueError("schur_pack kernel: the plan was built for another "
                         "row count")
    rows = torch.empty((Nr, record_width(lm, j_m.dtype, K)),
                       dtype=j_m.dtype, device=j_m.device)
    src = [t.contiguous() for t in floats]
    jl_ptr = src[2].data_ptr() if lm else None
    jc_ptr = src[-1].data_ptr() if K else None
    if Nr == 0:
        return SchurPack(rows, lm, K)
    stream = torch.cuda.current_stream(j_m.device).cuda_stream
    rc = _fn("ba_schur_pack", j_m.dtype, _PACK_ARGTYPES)(
        lm, K, src[0].data_ptr(), src[1].data_ptr(), jl_ptr, jc_ptr,
        plan.perm.contiguous().data_ptr(), Nr, rows.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"schur_pack kernel launch failed: CUDA error {rc}")
    schur_pack.launches += 1
    return SchurPack(rows, lm, K)


schur_pack.launches = 0


def schur_matvec(pack: SchurPack, plan: SchurPlan, vinv, x, D: int,
                 out=None, xk=None):
    """The rows of `schur_matvec_sorted_plain`, (Nr, 2, 6), from one launch
    of the CUDA kernel; vinv (L, lm, lm) (not read at lm 0), x (P * D,);
    `out`, when given, is a contiguous (Nr, 2, 6) tensor the rows are
    written into.  With a calibration block (pack.K > 0) x_k (K,) is the
    calibration part of x, and the result is (rows, each tile's sum of
    J_c^T w (n_tiles, K)), as `schur_matvec_sorted_plain` returns it."""
    W, lm, K = pack
    _check_lm(lm, K)
    Nr = W.shape[0]
    if K and (xk is None or xk.shape != (K,)):
        raise ValueError(f"schur_matvec kernel: x_k must be ({K},)")
    floats = (W, vinv, x) + ((xk,) if K else ())
    if not all(t.is_cuda and t.device == x.device
               for t in floats + (plan.ids, plan.tiles)):
        raise ValueError("schur_matvec kernel: all tensors must be on one "
                         "CUDA device")
    if x.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != x.dtype for t in floats):
        raise TypeError("schur_matvec kernel: unsupported dtypes "
                        f"{[t.dtype for t in floats]}")
    width = record_width(lm, x.dtype, K)
    if W.shape != (Nr, width) or not _aligned(W):
        raise ValueError("schur_matvec kernel: the pack must be a contiguous, "
                         f"16-byte-aligned (Nr, {width}) tensor")
    if lm and (vinv.dim() != 3 or vinv.shape[1:] != (lm, lm)):
        raise ValueError(f"schur_matvec kernel: vinv must be (L, {lm}, {lm})"
                         f", not {tuple(vinv.shape)}")
    if plan.ids.dtype != torch.int32 or plan.ids.shape != (Nr, 4) \
            or not _aligned(plan.ids) or plan.tiles.dtype != torch.int32 \
            or plan.tiles.shape != (-(-Nr // H) + 1,):
        raise ValueError("schur_matvec kernel: the plan was built for "
                         "another row count")
    if D < 6 or x.dim() != 1 or x.shape[0] % D:
        raise ValueError(f"schur_matvec kernel: x must be (P * {D},)")
    if out is None:
        out = torch.empty((Nr, 2, 6), dtype=x.dtype, device=x.device)
    elif out.shape != (Nr, 2, 6) or out.dtype != x.dtype \
            or out.device != x.device or not _aligned(out):
        raise ValueError("schur_matvec kernel: out must be a contiguous, "
                         f"16-byte-aligned ({Nr}, 2, 6) tensor")
    n_tiles = plan.tiles.shape[0] - 1
    partial = (torch.empty((n_tiles, K), dtype=x.dtype, device=x.device)
               if K else None)
    if Nr == 0:
        return (out, partial.zero_()) if K else out
    vinv, x = vinv.contiguous(), x.contiguous()
    xk_ptr = xk.contiguous().data_ptr() if K else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _fn("ba_schur_matvec", x.dtype, _ARGTYPES)(
        lm, K, W.data_ptr(), plan.ids.data_ptr(),
        plan.tiles.contiguous().data_ptr(), n_tiles, vinv.data_ptr(),
        x.data_ptr(), xk_ptr, D, out.data_ptr(),
        partial.data_ptr() if K else None, stream)
    if rc != 0:
        raise RuntimeError(f"schur_matvec kernel launch failed: CUDA error "
                           f"{rc}")
    schur_matvec.launches += 1
    return (out, partial) if K else out


schur_matvec.launches = 0
