"""The profiled window: `torch.profiler` over whole solves, read back.

The device's busy time is the union of the kernel, copy and set spans
(`profile_port.py`'s method, its sum replaced by the union so that nothing
is counted twice); the launches are the kernel spans; the idle gaps are the
spaces between device spans, each named by the innermost host operation
running at its start.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_events(prof):
    """[(name, start_us, end_us, is_kernel)] of the device spans, and the
    host operations [(name, start_us, end_us)]."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kind = "kernel"
            low = e.name.lower()
            if "memcpy" in low:
                kind = "gpu_memcpy"
            elif "memset" in low:
                kind = "gpu_memset"
            dev.append((e.name, tr.start, tr.end, kind == "kernel"))
        else:
            host.append((e.name, tr.start, tr.end))
    return dev, host


def profile(run, min_seconds: float, min_calls: int = 1):
    """Run `run()` (one solve, ending in a synchronize) under the profiler
    until `min_calls` calls and `min_seconds` have passed.  Returns
    (window_s, calls, the profiler)."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    calls = 0
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while calls < min_calls or time.perf_counter() - t0 < min_seconds:
            run()
            calls += 1
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return window, calls, prof


def read(prof, window_s: float) -> dict:
    """busy_s, kernel spans by name, launches, and the breakdown of the
    profiled window."""
    dev, host = _device_events(prof)
    spans = sorted((s, e) for _, s, e, _ in dev)
    busy_us, cur_s, cur_e = 0.0, None, None
    gaps = []
    for s, e in spans:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name = defaultdict(float)
    count = defaultdict(int)
    for name, s, e, is_kernel in dev:
        by_name[name] += (e - s) * 1e-6
        count[name] += 1
    launches = sum(1 for *_, k in dev if k)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy_us * 1e-6, window_s=window_s,
                kernel_s=dict(by_name), kernel_n=dict(count),
                launches=launches,
                breakdown=dict(device_ops=[[n, s] for n, s in ops],
                               idle_gaps=_idle_by_host(gaps, host)))


def _idle_by_host(gaps, host):
    """The idle gaps summed by the innermost host operation running at
    each gap's start, the ten largest."""
    if not gaps:
        return []
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    import bisect
    tot = defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        best, best_len = "host (no operation)", None
        # the innermost operation covering g0: the latest-starting one among
        # the last 32 that began before it
        for j in range(i - 1, max(-1, i - 32), -1):
            name, s, e = host[j]
            if e >= g0 and (best_len is None or e - s < best_len):
                best, best_len = name, e - s
        tot[best] += (g1 - g0) * 1e-6
    return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:10]]
