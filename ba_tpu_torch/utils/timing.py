"""Scoped wall-clock timers + profiler hooks (port of
`ba_tpu/utils/timing.py`).

Parity with the reference's timing macros (`StartTimer/PrintTimer`,
include/ba/Utils.h:51-62,102-110) and its instrumented solver spans.
`span` accumulates the wall time of a region by name; with `sync` it
first waits for the device that holds the given tensor(s), so it times
the device work and not only the launches.  `trace_to` wraps a region in
`torch.profiler` and writes a Chrome trace (chrome://tracing, Perfetto)
with the host's operators and, on a CUDA device, each kernel's device
time.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_accum: dict[str, float] = defaultdict(float)
_count: dict[str, int] = defaultdict(int)


def wait(x) -> None:
    """Wait for the CUDA devices that hold the tensors of `x` (a tensor, a
    dataclass tree, or a tuple / list / dict of them)."""
    from .tree import tree_map

    devices = set()

    def visit(t):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            devices.add(t.device)
        return t

    if isinstance(x, dict):
        x = list(x.values())
    for t in (x if isinstance(x, (list, tuple)) else [x]):
        tree_map(visit, t)
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def span(name: str, sync=None):
    """Accumulate wall time of a region.  Pass `sync` (a tensor or tree of
    tensors, or a callable returning one) to wait for its device before
    the clock stops, to time device work, not just dispatch."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            wait(sync() if callable(sync) else sync)
        _accum[name] += time.perf_counter() - t0
        _count[name] += 1


def report(reset: bool = True) -> str:
    lines = ["timing spans (total s / calls / mean ms):"]
    for k in sorted(_accum, key=lambda k: -_accum[k]):
        n = max(_count[k], 1)
        lines.append(f"  {k:32s} {_accum[k]:8.3f}  {n:6d}  "
                     f"{_accum[k] / n * 1e3:8.2f}")
    if reset:
        _accum.clear()
        _count.clear()
    return "\n".join(lines)


@contextlib.contextmanager
def trace_to(logdir: str):
    """torch.profiler trace of the region, written as a Chrome trace to
    `logdir/trace.json` (CUDA activity included when CUDA is available)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
