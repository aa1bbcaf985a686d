"""Kernel 7: the grouped banded Schur correction (CUDA).

Replaces the TPU formulation `ba_tpu/solver/banded.py:_band_schur_grouped`
(:96-133), which forms every landmark's W-block pair products as one
(L, B, B, 6, 6) batched einsum (678 MB in f32 at P = 2048, B = 24), sums
them per anchor pose and folds them onto the band by B shifted adds.  Its
plain PyTorch port is `solver/banded.py:band_schur_plain`; the wrapper in
`banded._band_schur_grouped` takes it for CPU tensors.

Design (csrc/band_schur.cu): the index work is static per problem, so it
happens once per solve, in a `SchurPlan`: each landmark's first observing
pose, each W block's local slot, the (L, B) table of the W block of landmark
l at slot s, and a CSR of the kept W blocks by pose.  One thread block per
pose walks its W blocks in that fixed order, in chunks: it looks up the rows
of the same landmark's blocks at the next B - i_loc slots, stages their
values and Wb V^-1 in shared memory, and adds the 6x6 products into the
output entries it owns: no (L, B, B, 6, 6) intermediate, no atomics,
bit-identical from launch to launch.

Bound on an H100: bytes (4.4 MB of W blocks read and 7.1 MB of output
written at the full-width trajectory, f32; ~3.4 us at 3.35 TB/s).

Scope: inverse-depth landmarks (lm_size 1), float32 and float64.  Other
landmark sizes raise on the card (ROADMAP.md queue 1, the kernel
variants).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build, segsum

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I, _I] + [_P, _P]


class SchurPlan(NamedTuple):
    """The static index work of the grouped Schur correction, on the W
    block tables' device."""

    B: int
    perm: torch.Tensor      # (Nw,) int32: kept W blocks by pose, then the
    #                         dropped ones (never read)
    offsets: torch.Tensor   # (P + 1,) int32: pose a owns perm[off[a]:off[a+1]]
    lm: torch.Tensor        # (Nw,) int32 landmark of each W block
    slot: torch.Tensor      # (Nw,) int32 local slot i_loc, -1 when dropped
    slot_row: torch.Tensor  # (L * B,) int32 W block of landmark l at slot s,
    #                         or -1


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
    device, with no host read."""
    dev = wb_pose.device
    i_loc, kept = slot_of(wb_pose, wb_lm, L, B)
    perm, offsets = segsum.segment_csr(torch.where(kept, wb_pose.long(), P),
                                       P)
    slot_row = torch.full((L * B + 1,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(wb_pose.shape[0], dtype=torch.int32, device=dev)
    slot_row = slot_row.index_put(
        (torch.where(kept, wb_lm.long() * B + i_loc, L * B),), rows)[:L * B]
    return SchurPlan(B, perm.int(), offsets.int(),
                     wb_lm.int().clamp(0, max(L - 1, 0)).contiguous(),
                     torch.where(kept, i_loc, -1).int(),
                     slot_row.contiguous())


def _fn(dtype):
    lib = build.load("band_schur")
    name = {torch.float32: "ba_band_schur_f32",
            torch.float64: "ba_band_schur_f64"}[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def band_schur(Wb, vinv, plan: SchurPlan, P: int):
    """corr (P, B, 6, 6) from the W blocks (Nw, 6, 1) and the landmark
    inverses (L, 1, 1), one launch of the CUDA kernel on `plan`."""
    if not (Wb.is_cuda and vinv.is_cuda and Wb.device == vinv.device):
        raise ValueError("band_schur kernel: Wb and vinv must be on one CUDA "
                         "device")
    if Wb.dtype not in (torch.float32, torch.float64) \
            or vinv.dtype != Wb.dtype:
        raise TypeError(f"band_schur kernel: unsupported dtypes {Wb.dtype}, "
                        f"{vinv.dtype}")
    if Wb.dim() != 3 or Wb.shape[1] != 6 or vinv.shape[1:] != (1, 1) \
            or Wb.shape[2] != 1:
        raise NotImplementedError(
            "band_schur kernel covers inverse-depth landmarks (lm_size 1): "
            f"Wb {tuple(Wb.shape)}, vinv {tuple(vinv.shape)} (ROADMAP.md "
            "queue 1, the kernel variants)")
    B = plan.B
    if (B + 1) * (6 * Wb.element_size() + 4) > 48 * 1024:
        raise ValueError(f"band_schur kernel: band width {B} too wide")
    Nw, L = Wb.shape[0], vinv.shape[0]
    if plan.perm.shape[0] != Nw or plan.offsets.shape[0] != P + 1 \
            or plan.slot_row.shape[0] != L * B:
        raise ValueError("band_schur kernel: the plan was built for another "
                         "W block table")
    if any(t.device != Wb.device for t in plan[1:]):
        raise ValueError("band_schur kernel: plan and values on different "
                         "devices")
    Wb = Wb.contiguous()
    vinv = vinv.contiguous()
    out = torch.empty((P, B, 6, 6), dtype=Wb.dtype, device=Wb.device)
    stream = torch.cuda.current_stream(Wb.device).cuda_stream
    rc = _fn(Wb.dtype)(Wb.data_ptr(), vinv.data_ptr(), plan.perm.data_ptr(),
                       plan.offsets.data_ptr(), plan.lm.data_ptr(),
                       plan.slot.data_ptr(), plan.slot_row.data_ptr(), P, B,
                       out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"band_schur kernel launch failed: CUDA error {rc}")
    band_schur.launches += 1
    return out


band_schur.launches = 0
