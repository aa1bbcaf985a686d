#!/usr/bin/env python3
"""Where a Gauss-Newton iteration of the port spends its time on the card.

    python3 profile_port.py

On the flagship problem of chip_smoke.py (128 keyframes, f32, band width
24) it prints:

  * the stages of one `gn_iteration`, each timed on the host clock between
    two `torch.cuda.synchronize()` calls, averaged over several iterations;
  * the source lines that synchronize the host with the device, found with
    PyTorch's sync debug mode;
  * the operators with the most device time and the most host time under
    `torch.profiler`, and the device's busy share of the profiled window.

The device's busy time is the sum of the kernel and copy spans of the
profiler's trace (written to a temporary directory in the checkout and
deleted once read: two iterations make ~80 MB).  Needs one CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import chip_smoke

N_STAGE_ITERS = 5
N_PROFILE_ITERS = 2


def stage_times(p, cfg):
    """Mean seconds of each stage of `gn_iteration` over N_STAGE_ITERS."""
    import torch

    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.linear import solve_reduced

    sums = collections.defaultdict(float)
    plan = asm.assembly_plan(p, cfg)          # once per solve, as there

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sums[name] += time.perf_counter() - t0
        return out

    for _ in range(N_STAGE_ITERS + 1):
        if _ == 1:
            sums.clear()                       # the first pass warms up
        ie = timed("imu evaluate + Jacobians", lambda: step._imu_eval(
            p, cfg, True, True))
        colm6 = asm.col_mask(p, cfg, 6).to(p.poses.t.dtype)
        timed("reprojection blocks (kernel 1)",
              lambda: asm.proj_blocks(p, cfg, colm6))
        a = timed("assemble (whole, incl. the above blocks)",
                  lambda: asm.assemble(p, cfg, imu_eval=ie, plan=plan))
        s = timed("solve_reduced (Cholesky + back-substitution)",
                  lambda: solve_reduced(a))
        cand = timed("apply_update", lambda: step.apply_update(
            p, cfg, s.delta_p, s.delta_l))
        timed("trial cost (imu with cached c9 + kernel 1 + priors)",
              lambda: step._cost(cand, cfg, True, a.proj_w, ie.c9))
        timed("gn_iteration (whole)",
              lambda: step.gn_iteration(p, cfg, True, plan=plan))
    return {k: v / N_STAGE_ITERS for k, v in sums.items()}


def sync_sites(p, cfg):
    """Counter of the innermost repository frames of each synchronizing
    operation in one `gn_iteration`."""
    import torch

    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import assembly_plan

    plan = assembly_plan(p, cfg)
    sites = collections.Counter()
    root = str(chip_smoke.ROOT)

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if f.filename.startswith(root) and "profile_port" not in
                  f.filename]
        key = " <- ".join(f"{Path(f.filename).relative_to(root)}:{f.lineno}"
                          for f in frames[::-1][:3])
        sites[key] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step.gn_iteration(p, cfg, True, plan=plan)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def profile(p, cfg):
    import torch
    from torch.profiler import ProfilerActivity

    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import assembly_plan

    plan = assembly_plan(p, cfg)
    step.gn_iteration(p, cfg, True, plan=plan)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        q = p
        for _ in range(N_PROFILE_ITERS):
            q = step.gn_iteration(q, cfg, True, plan=plan).problem
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=chip_smoke.ROOT) as tmp:
        path = Path(tmp) / "profile_gn.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    busy_us = sum(e.get("dur", 0) for e in trace["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    ka = prof.key_averages()
    dev_key = ("self_device_time_total"
               if hasattr(ka[0], "self_device_time_total")
               else "self_cuda_time_total")
    print(ka.table(sort_by=dev_key, row_limit=20))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=20))
    return wall, busy_us * 1e-6


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    smi = chip_smoke.smi_line()
    chip_smoke.phase_build()
    _, p, cfg, _ = chip_smoke.flagship()
    cfg = dataclasses.replace(cfg, use_dogleg=False)

    for name, secs in stage_times(p, cfg).items():
        print(f"[{smi}] stage {name}: {secs * 1e3:.2f} ms")
    for site, n in sync_sites(p, cfg).most_common():
        print(f"sync x{n}: {site}")
    wall, busy = profile(p, cfg)
    print(f"[{smi}] profiled {N_PROFILE_ITERS} GN iterations: wall "
          f"{wall * 1e3:.1f} ms (profiler on), device busy {busy * 1e3:.1f} "
          f"ms = {100 * busy / wall:.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
