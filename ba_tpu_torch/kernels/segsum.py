"""segsum: grouped deterministic segmented block sum (CUDA).

Replaces the TPU formulation `ba_tpu/solver/assemble.py:seg_sum_blocks`
(:120-156): a one-hot MXU matmul below 512 segments and a serialized
scatter above.  It carries the seven normal-equation accumulations of a
banded build (the band grid, the pose rhs, the IMU grid and rhs, V, rhs_l
and the W blocks), ten with a calibration block, in one launch.

Design (csrc/segsum.cu): the segment ids of the main path are static per
problem, so the index work happens once, in a `SegPlan` built before the
solve loop: a stable sort of the rows by id, CSR offsets, and a work table
that cuts every segment into chunks of at most `R` rows.  A launch takes a
list of (values, plan) groups; one warp sums one chunk, and the chunks of
a long segment are combined in chunk order by the last of them to finish.
The order of every sum is fixed by the plan, so the output is bit-identical
from run to run — an atomics-ordered f32 sum would make the accept/reject
at the f32 cost floor wobble between runs.  Rows whose id is < 0 or
>= nseg sort past the last offset and are dropped, as `jax.ops.segment_sum`
and the one-hot form drop them.

`plan_walk` is the plain version of a launch on a plan (chunk sums, then
each segment's chunks in order); `solver/assemble.py:_seg_sum_plain` is
the independent reference both are held against.

Bound on an H100: bytes — each input row is read once and each output
written once (~9 MB per flagship build), against 3.35 TB/s; the adds are
negligible.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

R = 32            # rows per chunk: csrc/segsum.cu R (one warp's lanes)
MAX_GROUPS = 12   # groups per launch: csrc/segsum.cu MAX_GROUPS

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_I] + [_P] * 9 + [_P]


class SegPlan(NamedTuple):
    """The static index work of one segment sum, on the ids' device."""

    nseg: int
    perm: torch.Tensor      # (n,) int32: rows stably sorted by id
    offsets: torch.Tensor   # (nseg + 1,) int32: segment s owns
    #                         perm[offsets[s]:offsets[s + 1]]
    chunks: torch.Tensor    # (nseg + n // R, 4) int32 work table: segment
    #                         (-1 past the last chunk), first row in perm,
    #                         rows (<= R), index of the chunk in its segment
    #                         (-1 when the segment has one chunk)
    counters: torch.Tensor  # (nseg,) int32, zero between launches


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


def build_plan(ids, nseg: int) -> SegPlan:
    """The plan of `ids` (n,) over `nseg` segments, on the ids' device,
    with no host read.  The work table has a fixed length, nseg + n // R,
    an upper bound on the chunk count (each segment takes
    max(1, ceil(rows / R)) chunks); the rows past the real count are
    marked unused."""
    if ids.dim() != 1 or ids.dtype.is_floating_point \
            or ids.dtype == torch.bool:
        raise TypeError("segment plan: ids must be a 1-D integer tensor")
    dev = ids.device
    n = ids.shape[0]
    if n >= 2**31 or nseg >= 2**31:
        raise ValueError("segment plan: sizes must fit in int32")
    perm, offsets = segment_csr(ids, nseg)
    counters = torch.zeros((nseg,), dtype=torch.int32, device=dev)
    if nseg == 0:
        chunks = torch.zeros((0, 4), dtype=torch.int32, device=dev)
        return SegPlan(0, perm.int(), offsets.int(), chunks, counters)
    count = offsets[1:] - offsets[:-1]
    nchunk = torch.clamp((count + R - 1) // R, min=1)
    end = torch.cumsum(nchunk, 0)
    c = torch.arange(nseg + n // R, device=dev)
    seg = torch.searchsorted(end, c, right=True)
    used = seg < nseg
    s = torch.clamp(seg, max=nseg - 1)
    j = c - (end[s] - nchunk[s])
    chunks = torch.stack([
        torch.where(used, seg, -1),
        torch.where(used, offsets[s] + j * R, 0),
        torch.where(used, torch.clamp(count[s] - j * R, 0, R), 0),
        torch.where(used & (nchunk[s] > 1), j, -1)], dim=1).int()
    return SegPlan(nseg, perm.int(), offsets.int(), chunks.contiguous(),
                   counters)


def plan_walk(vals, plan: SegPlan):
    """The plain version of a launch on `plan`: every chunk's rows summed,
    then every segment's chunk sums added in chunk order.  (n, k) ->
    (nseg, k)."""
    n, k = vals.shape
    if n != plan.perm.shape[0]:
        raise ValueError(f"segment plan for {plan.perm.shape[0]} rows, "
                         f"not {n}")
    if n == 0 or plan.nseg == 0:
        return vals.new_zeros((plan.nseg, k))
    ch = plan.chunks.long()
    ch = ch[ch[:, 0] >= 0]
    seg, row0, rows, _ = ch.unbind(1)
    slot = torch.arange(R, device=vals.device)
    rid = plan.perm.long()[torch.clamp(row0[:, None] + slot, max=n - 1)]
    part = torch.where((slot < rows[:, None])[..., None], vals[rid],
                       0.0).sum(dim=1)
    m = torch.bincount(seg, minlength=plan.nseg)
    first = torch.cumsum(m, 0) - m
    q = torch.arange(int(m.max()), device=vals.device)
    cid = torch.clamp(first[:, None] + q, max=part.shape[0] - 1)
    return torch.where((q < m[:, None])[..., None], part[cid],
                       0.0).sum(dim=1)


def _fn(dtype):
    lib = build.load("segsum")
    name = {torch.float32: "ba_segsum_grouped_f32",
            torch.float64: "ba_segsum_grouped_f64"}[dtype]
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def seg_sum_grouped(groups):
    """[(vals (n, k), plan)] -> [out (nseg, k)], every sum from one launch
    of the CUDA kernel.  `vals` are contiguous float32/float64 CUDA tensors
    of one dtype on one device, each with the plan built from its ids; a
    plan may appear once per launch."""
    if not groups:
        return []
    v0 = groups[0][0]
    if not v0.is_cuda:
        raise ValueError("segsum kernel: values must be on a CUDA device")
    if v0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segsum kernel: unsupported dtype {v0.dtype}")
    if len({id(plan) for _, plan in groups}) != len(groups):
        raise ValueError("segsum kernel: a plan appears twice in one launch "
                         "(its counters would be shared)")
    outs, live = [], []
    for vals, plan in groups:
        if vals.dtype != v0.dtype or vals.device != v0.device:
            raise TypeError("segsum kernel: groups of mixed dtype or device")
        if vals.dim() != 2 or not vals.is_contiguous():
            raise ValueError("segsum kernel: vals must be contiguous (n, k)")
        if vals.shape[0] != plan.perm.shape[0]:
            raise ValueError("segsum kernel: the plan was built for "
                             f"{plan.perm.shape[0]} rows, not "
                             f"{vals.shape[0]}")
        if any(t.device != v0.device for t in plan[1:]):
            raise ValueError("segsum kernel: plan and values on different "
                             "devices")
        out = torch.empty((plan.nseg, vals.shape[1]), dtype=vals.dtype,
                          device=vals.device)
        outs.append(out)
        if plan.nseg and vals.shape[1]:
            live.append((vals, plan, out))
    if not live:
        return outs
    if len(live) > MAX_GROUPS:
        raise ValueError(f"segsum kernel: at most {MAX_GROUPS} groups per "
                         "launch")
    sizes = [plan.chunks.shape[0] * vals.shape[1] for vals, plan, _ in live]
    scratch = torch.empty((sum(sizes),), dtype=v0.dtype, device=v0.device)
    parts = torch.split(scratch, sizes)

    def ptrs(ts):
        return (_P * len(ts))(*[t.data_ptr() for t in ts])

    G = len(live)
    stream = torch.cuda.current_stream(v0.device).cuda_stream
    rc = _fn(v0.dtype)(
        G, ptrs([v for v, _, _ in live]), ptrs([o for _, _, o in live]),
        ptrs(parts), ptrs([p.perm for _, p, _ in live]),
        ptrs([p.offsets for _, p, _ in live]),
        ptrs([p.chunks for _, p, _ in live]),
        ptrs([p.counters for _, p, _ in live]),
        (_I * G)(*[v.shape[1] for v, _, _ in live]),
        (_I * G)(*[p.chunks.shape[0] for _, p, _ in live]), stream)
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed: CUDA error {rc}")
    seg_sum_grouped.launches += 1
    return outs


seg_sum_grouped.launches = 0


def seg_sum(vals, ids, nseg: int):
    """out[s] = sum of vals[i] over rows with ids[i] == s, (nseg, k): one
    group through the grouped kernel, its plan built on every call (a sort
    and a search; the solve builds its plans once instead).  `vals` is a
    contiguous (n, k) float32/float64 CUDA tensor, `ids` (n,) integer on
    the same device."""
    if not (vals.is_cuda and ids.is_cuda and vals.device == ids.device):
        raise ValueError("segsum kernel: vals and ids must be on one CUDA "
                         "device")
    if ids.dim() != 1 or ids.shape[0] != vals.shape[0]:
        raise ValueError("segsum kernel: ids must be (n,) matching vals")
    return seg_sum_grouped([(vals, build_plan(ids, nseg))])[0]
