"""The program's spans and counters, and the profiler hooks (port of
`ba_tpu/utils/timing.py`, the reference's `StartTimer/PrintTimer` macros,
include/ba/Utils.h:51-62,102-110, and its instrumented solver spans).

A span (`span(name)`) is a region of the program: its name, its host
start and end (`time.perf_counter_ns`), its parent span and the solve id
of the `solve` span it sits under.  A span on a CUDA device also records
a timing event on the device's current stream at entry and at exit; the
time between the two is the span's *stream time*, what the queue took to
run the span's work, overlap with the host included.  No span waits for
the device: the events are read only when a summary is asked for.

Tracing is on while `enable()` is in force or while a `torch.profiler`
records; off, a span site costs one flag test.  Under the profiler each
span is also a host range of the profiler (on its clock, beside the
device's kernels), which `trace_to`'s Chrome trace shows and `attribute`
reads.  The ranges are function-scope records: they draw no range on the
device's timeline, so the profiler's device spans stay the kernels,
copies and sets.

The span names of the solver (`solver/`, `utils/sync.py`):

  solve           `step.solve_fixed`, `step.solve_adaptive` (holds the id)
  plan            `step.solve_plan` (with a fused fleet's one host read)
  iteration       `step.gn_iteration`, `step.dogleg_iteration`
  reweight        `step.apply_robust_reweighting`
  imu             `step._imu_eval`, with or without Jacobians
  build           `cg.assemble_blocks`, `assemble.assemble`
  reduced.<path>  the reduced solve: cg, fleet_dense, banded,
                  banded_dense, dense
  pcg.product     each Schur product (`cg.s_matvec`) of `cg.pcg_solve`
  back_substitute `cg.back_substitute_blocks`
  cauchy          the dogleg's Cauchy factor (both assembly paths)
  update          `step.apply_update`
  trial           `step._cost`, a trial cost
  dogleg.search   `step.dogleg_search`
  push            `streaming.StreamingRing.push`
  marginalize     `window.marginalize`
  host_read       each counted read of `sync.item` / `sync.values`

and its counters (`count`), set at the end of each `cg.pcg_solve`:
`pcg.products` (Schur products launched), `pcg.stop_reads` (host reads of
the stop test) and `pcg.iterations` (products that moved x: a device
count, read at summary time).

    with timing.enable():
        step.solve_fixed(problem, config, use_imu, 10)
    print(timing.report())
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler
# a function-scope range: `torch.profiler.record_function`'s user scope
# would also draw each span on the device's timeline as if it were a kernel
from torch._C._profiler import _RecordFunctionFast as _Range

_enabled = 0                 # depth of `enable()`
_records: list = []          # every span recorded, in order of entry
_counters: dict = {}         # name -> int, or a device tensor
_names: set = set()          # every span name recorded since import
_pools: dict = {}            # device -> [events], reused after `reset()`
_taken: dict = {}            # device -> events handed out since `reset()`
_local = threading.local()   # each thread's stack of open spans
_lock = threading.Lock()     # the pools and counters, shared by threads
_solve_ids = itertools.count(1)


@contextlib.contextmanager
def enable():
    """Record spans and counters inside the block, profiler or not."""
    global _enabled
    _enabled += 1
    try:
        yield
    finally:
        _enabled -= 1


class _Off:
    """The span of a site while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _event(device):
    with _lock:
        pool = _pools.setdefault(device, [])
        i = _taken.get(device, 0)
        if i == len(pool):
            pool.append(torch.cuda.Event(enable_timing=True))
        _taken[device] = i + 1
        return pool[i]


class _Span:
    """A span while tracing is on, and its record in the store."""

    __slots__ = ("name", "like", "parent", "sid", "device", "t0", "t1",
                 "ev0", "ev1", "rng")

    def __init__(self, name, like):
        self.name, self.like = name, like
        self.t1 = self.ev0 = self.ev1 = self.rng = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = self.parent = stack[-1] if stack else None
        if self.like is None:
            self.device = parent.device if parent is not None else None
        else:
            dev = (self.like if isinstance(self.like, torch.device)
                   else self.like.device)
            self.device = dev if dev.type == "cuda" else None
        if parent is not None and parent.sid is not None:
            self.sid = parent.sid
        else:
            self.sid = next(_solve_ids) if self.name == "solve" else None
        _records.append(self)
        _names.add(self.name)
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self.rng = _Range(self.name)
            self.rng.__enter__()
        self.t0 = time.perf_counter_ns()
        if self.device is not None:
            self.ev0 = _event(self.device)
            self.ev0.record(torch.cuda.current_stream(self.device))
        return None

    def __exit__(self, *exc):
        if self.device is not None:
            self.ev1 = _event(self.device)
            self.ev1.record(torch.cuda.current_stream(self.device))
        self.t1 = time.perf_counter_ns()
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        _local.stack.pop()
        return False


def span(name: str, like=None):
    """A span of the region `with span(name): ...`.  `like`, a tensor or a
    device, puts its events on that device's current stream (a CUDA one);
    without it the span takes its parent's device.  Off, it records
    nothing."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, like)


def count(name: str, n) -> None:
    """Add `n` to the counter `name` while tracing is on: a host integer,
    or a device scalar summed on the device and read by `summary`."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return
    if isinstance(n, torch.Tensor):
        n = n.detach()
    with _lock:
        prev = _counters.get(name)
        _counters[name] = n if prev is None else prev + n


def reset() -> None:
    """Empty the store; the events go back to their pools."""
    _records.clear()
    _counters.clear()
    _taken.clear()


def summary() -> dict:
    """{"spans": {name: {calls, host_s, self_s, wait_s, stream_s,
    stream_self_s}}, "counters": {name: value}} over the store.  host_s:
    the spans' host seconds; self_s: host seconds less the direct child
    spans'; wait_s: host seconds inside the `host_read` spans nested in
    them; stream_s and stream_self_s: the same on the stream (None where
    no span of the name ran on a CUDA device).  Waits once for each device
    that holds events."""
    for dev in {r.device for r in _records if r.ev1 is not None}:
        torch.cuda.synchronize(dev)
    done = [r for r in _records if r.t1 is not None]     # closed spans
    stream = {id(r): r.ev0.elapsed_time(r.ev1) * 1e-3
              for r in done if r.ev1 is not None}
    child, child_st, wait = (defaultdict(float) for _ in range(3))
    for r in done:
        d = (r.t1 - r.t0) * 1e-9
        if r.parent is not None:
            child[id(r.parent)] += d
            child_st[id(r.parent)] += stream.get(id(r), 0.0)
        if r.name == "host_read":
            p = r.parent
            while p is not None:
                wait[id(p)] += d
                p = p.parent
    spans = {}
    for r in done:
        s = spans.setdefault(r.name, dict(calls=0, host_s=0.0, self_s=0.0,
                                          wait_s=0.0, stream_s=None,
                                          stream_self_s=None))
        d = (r.t1 - r.t0) * 1e-9
        s["calls"] += 1
        s["host_s"] += d
        s["self_s"] += d - child[id(r)]
        s["wait_s"] += wait[id(r)]
        if id(r) in stream:
            st = stream[id(r)]
            s["stream_s"] = (s["stream_s"] or 0.0) + st
            s["stream_self_s"] = ((s["stream_self_s"] or 0.0) + st
                                  - child_st[id(r)])
    counters = {k: (v.item() if isinstance(v, torch.Tensor) else v)
                for k, v in _counters.items()}
    return dict(spans=spans, counters=counters)


def report() -> str:
    """`summary` as a table, the spans by host seconds."""
    s = summary()
    lines = ["spans (calls / host s / stream s / self s / host-read s / "
             "host ms a call):"]
    for k, v in sorted(s["spans"].items(), key=lambda kv: -kv[1]["host_s"]):
        st = "-" if v["stream_s"] is None else f"{v['stream_s']:9.4f}"
        lines.append(f"  {k:22s} {v['calls']:7d} {v['host_s']:9.4f} {st:>9s} "
                     f"{v['self_s']:9.4f} {v['wait_s']:9.4f} "
                     f"{v['host_s'] / v['calls'] * 1e3:9.3f}")
    for k, v in sorted(s["counters"].items()):
        lines.append(f"  counter {k:14s} {v:g}")
    return "\n".join(lines)


def attribute(prof) -> dict:
    """Seconds of device idle in a finished `torch.profiler` run, by the
    innermost program span open on the host at each idle gap's start
    ("(no span)" where none was).  The gaps are the spaces between the
    union of the device's kernel, copy and set spans."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((tr.start, tr.end))
        elif e.name in _names:
            host.append((tr.start, -tr.end, e.name))
    gaps, cur = [], None
    for s, e in sorted(dev):
        if cur is not None and s > cur:
            gaps.append((cur, s))
        cur = e if cur is None else max(cur, e)
    host.sort()
    out = defaultdict(float)
    open_, i = [], 0
    for g0, g1 in gaps:
        while i < len(host) and host[i][0] <= g0:
            open_.append((-host[i][1], host[i][2]))
            i += 1
        open_ = [o for o in open_ if o[0] >= g0]   # those still open
        out[open_[-1][1] if open_ else "(no span)"] += (g1 - g0) * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


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
def trace_to(logdir: str):
    """torch.profiler trace of the region, written as a Chrome trace to
    `logdir/trace.json` (CUDA activity included when CUDA is available):
    the host's operators and the program's spans over the device's
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
