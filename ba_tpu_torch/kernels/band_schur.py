"""Kernel 7: the grouped banded Schur correction (CUDA).

Replaces the TPU formulation `ba_tpu/solver/banded.py:_band_schur_grouped`
(:96-133), which forms every landmark's W-block pair products as one
(L, B, B, 6, 6) batched einsum (678 MB in f32 at P = 2048, B = 24), sums
them per anchor pose and folds them onto the band by B shifted adds.  Its
plain PyTorch port is `solver/banded.py:band_schur_plain`; the wrapper in
`banded._band_schur_grouped` takes it for CPU tensors.

Design (csrc/band_schur.cu): the index work is static per problem, so it
happens once per solve, in a `SchurPlan`: the kept W blocks sorted by
(pose, landmark), so that each pose's blocks are one run ascending in
landmark, with each pose's offset into it, the blocks' landmark ids and,
per tile, where its run starts in the W block table.  One thread block
owns TILE_POSES consecutive poses, a warp each, and stages the run of
their blocks and of the next B - 1 poses' (their partners) in shared
memory, with u = Wb V^-1 of its own; the partners of poses a and a + d
are the landmarks both sorted runs hold, found by a merge walk per lane
(lane d), which adds the 6x6 products of block (a, d) in registers: no
(L, B, B, 6, 6) intermediate, no atomics, bit-identical from launch to
launch.  A run larger than the block's shared memory (`capacities`) is
walked in pieces, in the same order of sums.

Bound on an H100: bytes (4.4 MB of W blocks, 1.5 MB of their ids and 7.1
MB of output at the full-width trajectory, f32; ~3.9 us at 3.35 TB/s).

Scope: inverse-depth and XYZ landmarks (lm_size 1 and 3), float32 and
float64.  A pose graph (lm_size 0) has no Schur correction and raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_I] + [_P] * 6 + [_I] * 5 + [_P, _P]

# poses per thread block (csrc/band_schur.cu:TP), and the shared memory a
# block stages its rows in: one block per SM
TILE_POSES = 16
SMEM_BUDGET = 220 * 1024


class SchurPlan(NamedTuple):
    """The static index work of the grouped Schur correction, on the W
    block tables' device."""

    B: int
    perm: torch.Tensor      # (Nw,) int32: kept W blocks by (pose,
    #                         landmark), then the dropped ones (never read)
    offsets: torch.Tensor   # (P + 1,) int32: pose a owns perm[off[a]:off[a+1]]
    lm: torch.Tensor        # (Nw,) int32 landmark of W block perm[k]
    tile_src: torch.Tensor  # (ceil(P / TILE_POSES),) int32: the W block
    #                         table row where a tile's run starts when the
    #                         run is consecutive rows of the table, else -1


def first_pose(wb_pose, wb_lm, L: int):
    """Each landmark's first observing pose (L,), 0 for a landmark with no
    W block; padding rows (wb_lm == L) are left out."""
    big = torch.iinfo(torch.int64).max
    first = torch.full((L + 1,), big, dtype=torch.int64,
                       device=wb_pose.device)
    first = first.scatter_reduce(0, wb_lm.long().clamp(0, L), wb_pose.long(),
                                 "amin")[:L]
    return torch.where(first == big, 0, first)


def slot_of(wb_pose, wb_lm, L: int, B: int):
    """(i_loc, kept) of every W block: its pose less its landmark's first
    observing pose, and whether the grouped formulation keeps it (a real
    landmark and 0 <= i_loc < B)."""
    wl = wb_lm.long()
    first = first_pose(wb_pose, wb_lm, L)
    i_loc = wb_pose.long() - first[wl.clamp(0, L - 1)]
    kept = (wl < L) & (i_loc >= 0) & (i_loc < B)
    return i_loc, kept


def schur_plan(wb_pose, wb_lm, P: int, L: int, B: int) -> SchurPlan:
    """The plan of the W block table (wb_pose, wb_lm) (Nw,), on its
    device, with no host read.  The kept blocks of two landmarks seen from
    one pose are paired only through their landmark ids, so the table must
    hold one W block per (pose, landmark), as `core/problem.py`'s does."""
    dev = wb_pose.device
    _, kept = slot_of(wb_pose, wb_lm, L, B)
    key = torch.where(kept, wb_pose.long() * (L + 1) + wb_lm.long(),
                      P * (L + 1))
    skey, perm = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        skey, torch.arange(P + 1, device=dev, dtype=torch.int64) * (L + 1))
    lm = wb_lm.long()[perm].clamp(0, max(L - 1, 0))
    # a tile's run: the sorted rows of poses [a0, a0 + TILE_POSES + B - 1)
    a0 = torch.arange(0, P, TILE_POSES, device=dev)
    r0 = offsets[a0]
    r1 = offsets[(a0 + TILE_POSES + B - 1).clamp(max=P)]
    brk = torch.cat([perm.new_zeros(1), (perm[1:] != perm[:-1] + 1).long()])
    brk = brk.cumsum(0)
    n = perm.shape[0]
    last = (r1 - 1).clamp(0, max(n - 1, 0))
    first = r0.clamp(0, max(n - 1, 0))
    if n == 0:
        tile_src = torch.zeros_like(a0)
    else:
        tile_src = torch.where((r1 - r0 <= 1) | (brk[last] == brk[first]),
                               perm[first], -1)
    return SchurPlan(B, perm.int(), offsets.int(), lm.int(), tile_src.int())


def capacities(B: int, lm: int, itemsize: int):
    """(shared KB, left rows, partner rows): a thread block stages a
    tile's whole run when it fits SMEM_BUDGET (the kernel decides per
    tile), else pieces of left rows (the tile's own: u and ids) and
    partner rows (W and ids), split in the proportion of their poses,
    TILE_POSES to TILE_POSES + B - 1."""
    rows = (SMEM_BUDGET - 128) // (6 * lm * itemsize + 4)
    cl = max(1, rows * TILE_POSES // (2 * TILE_POSES + B - 1))
    return SMEM_BUDGET // 1024, cl, max(cl, rows - cl)


def _fn(dtype):
    lib = build.load("band_schur")
    name = {torch.float32: "ba_band_schur_f32",
            torch.float64: "ba_band_schur_f64"}[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def band_schur(Wb, vinv, plan: SchurPlan, P: int, caps=None):
    """corr (P, B, 6, 6) from the W blocks (Nw, 6, lm) and the landmark
    inverses (L, lm, lm), lm 1 or 3, one launch of the CUDA kernel on
    `plan`.  `caps` (left rows, partner rows, left <= partner) stages
    every run that does not fit their shared memory in pieces of that
    many rows: the piecewise walk, forced."""
    if not (Wb.is_cuda and vinv.is_cuda and Wb.device == vinv.device):
        raise ValueError("band_schur kernel: Wb and vinv must be on one CUDA "
                         "device")
    if Wb.dtype not in (torch.float32, torch.float64) \
            or vinv.dtype != Wb.dtype:
        raise TypeError(f"band_schur kernel: unsupported dtypes {Wb.dtype}, "
                        f"{vinv.dtype}")
    lm = Wb.shape[2] if Wb.dim() == 3 else -1
    if Wb.dim() != 3 or Wb.shape[1] != 6 or lm not in (1, 3) \
            or vinv.dim() != 3 or vinv.shape[1:] != (lm, lm):
        raise NotImplementedError(
            "band_schur kernel covers inverse-depth and XYZ landmarks "
            f"(lm_size 1, 3): Wb {tuple(Wb.shape)}, vinv "
            f"{tuple(vinv.shape)}")
    B = plan.B
    Nw = Wb.shape[0]
    if plan.perm.shape[0] != Nw or plan.offsets.shape[0] != P + 1 \
            or plan.lm.shape[0] != Nw \
            or plan.tile_src.shape[0] != -(-P // TILE_POSES):
        raise ValueError("band_schur kernel: the plan was built for another "
                         "W block table")
    if any(t.device != Wb.device for t in plan[1:]):
        raise ValueError("band_schur kernel: plan and values on different "
                         "devices")
    kb, cl, cr = capacities(B, lm, Wb.element_size()) if caps is None \
        else (1, *caps)
    Wb = Wb.contiguous()
    if Wb.data_ptr() % 16:     # the staging copies read 16-byte units
        Wb = Wb.clone()
    vinv = vinv.contiguous()
    out = torch.empty((P, B, 6, 6), dtype=Wb.dtype, device=Wb.device)
    stream = torch.cuda.current_stream(Wb.device).cuda_stream
    rc = _fn(Wb.dtype)(lm, Wb.data_ptr(), vinv.data_ptr(),
                       plan.perm.data_ptr(), plan.offsets.data_ptr(),
                       plan.lm.data_ptr(), plan.tile_src.data_ptr(), P, B,
                       kb, cl, cr, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"band_schur kernel launch failed: CUDA error {rc}")
    band_schur.launches += 1
    return out


band_schur.launches = 0
