#!/usr/bin/env python3
"""Where a Gauss-Newton iteration and a streaming slide of the port spend
their time on the card.

    python3 profile_port.py

On the flagship problem of chip_smoke.py (128 keyframes, f32, band width
24) it prints:

  * the stages of one `gn_iteration`, each timed on the host clock between
    two `torch.cuda.synchronize()` calls, averaged over several iterations;
  * the source lines that synchronize the host with the device, found with
    PyTorch's sync debug mode;
  * the operators with the most device time and the most host time under
    `torch.profiler`, and the device's busy share of the profiled window.

With `--long`, instead, on chip_smoke.py's long trajectory (2,048
keyframes, f32, band width 24, the banded solver) it prints the stages of
one GN iteration (IMU, assemble_blocks, band_S with kernel 7, the
scaling and chunk layout (K8a), the cyclic-reduction factor (K8b), the PCG
wrap with kernel 9 and five solves (K8c), the back-substitution, the
Cauchy factor, the trial cost), the synchronizing
source lines of an iteration, and the device's busy share and kernel
launches of one profiled iteration.

    python3 profile_port.py --long

With `--cg` or `--fleet`, the same on chip_smoke.py's PCG configuration
(1,024 keyframes, `use_cg_solver`: IMU, assemble_blocks with the
preconditioner, the PCG with its Schur products through kernels 6 and 2
and the preconditioner, ...) or on its fused fleet (4 x 128 keyframes: the
families' band, kernel 10 (a) and (b), the batched Cholesky and the
triangular solves, ...).  With `--selfcal`, on chip_smoke.py's full-width
self-calibration configuration (128 keyframes, 15-dim states, 11
calibration columns, the general dense path: IMU through K2, kernel 1 with
the calibration columns, the assembly with its calibration block in one
segsum launch, the Cholesky of the 1,931-row S, the calibration update
with its re-unprojection, the trial cost).

On the stream of chip_smoke.py (W = 10, 2 GN iterations per slide, f32) it
prints the stages of one `StreamingRing.push`, timed the same way over
several slides after a warm-up: the host's table build and packing, the
upload, the two builds with their solves, the two trial costs, the
marginalization and the whole push; the synchronizing source lines of a
push; and the device's busy share of a few profiled pushes, with the
busy time per push and K5's and K11's part of it.

With `--k11-against FILE.cu`, instead, it builds FILE.cu (a K11 source of
the same C interface, for example an earlier commit's
`ba_tpu_torch/kernels/csrc/marginalize.cu` written out under `_archive/`)
with the package's nvcc line and times it beside this tree's K11 on the
indefinite inputs of chip_smoke.py's `k11` phase (n = 90, 169, 360; the
Jacobi branch), each checked against the plain version first:

    git show <commit>:ba_tpu_torch/kernels/csrc/marginalize.cu \
        > _archive/marginalize_old.cu
    python3 profile_port.py --k11-against _archive/marginalize_old.cu

The device's busy time is the sum of the kernel and copy spans of the
profiler's trace (written to a temporary directory in the checkout and
deleted once read: two iterations make ~80 MB).  Needs one CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

import collections
import ctypes
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
        ie = timed("imu evaluate + Jacobians (K2 (a))",
                   lambda: step._imu_eval(p, cfg, True, True))
        colm6 = asm.col_mask(p, cfg, 6).to(p.poses.t.dtype)
        timed("reprojection blocks (kernel 1)",
              lambda: asm.proj_blocks(p, cfg, colm6))
        a = timed("assemble (whole, incl. the above blocks)",
                  lambda: asm.assemble(p, cfg, imu_eval=ie, plan=plan))
        s = timed("solve_reduced (Cholesky + back-substitution)",
                  lambda: solve_reduced(a))
        cand = timed("apply_update", lambda: step.apply_update(
            p, cfg, s.delta_p, s.delta_l))
        timed("trial cost (K2 (b) with cached c9 + kernel 1 + priors)",
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
    busy = _busy_seconds(prof, "profile_gn.json")
    ka = prof.key_averages()
    dev_key = ("self_device_time_total"
               if hasattr(ka[0], "self_device_time_total")
               else "self_cuda_time_total")
    print(ka.table(sort_by=dev_key, row_limit=20))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=20))
    return wall, busy


def slide_stage_times(smi, n_warm=3, n_slides=5):
    """Mean seconds per slide of each stage of a push, from timed wrappers
    around the functions a push calls (a stage's time includes the stages
    nested in it); then the sync sites of one push and the device's busy
    share of two profiled pushes."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity

    from ba_tpu_torch.apps.vins_stream import (add_keyframe, stream_feed,
                                               stream_problem)
    from ba_tpu_torch.solver import fixedlag, step, streaming, window
    from ba_tpu_torch.solver.streaming import RingCapacities, StreamingRing

    cfg_s = chip_smoke.STREAM
    problem, cfg, _ = stream_problem(cfg_s["poses"], cfg_s["lms"])
    W = cfg_s["window"]
    sched = fixedlag.build_ring_schedule(problem, cfg, W,
                                         cfg_s["poses"] - W + 1)
    ring = StreamingRing(cfg, W, problem.rig, problem.g_vec,
                         RingCapacities.from_schedule(sched), use_imu=True,
                         iters_per_slide=cfg_s["iters"], dtype=np.float32)
    feed = stream_feed(problem)
    sums = collections.defaultdict(float)
    on = [False]

    def wrap(owner, name, label):
        _wrap(owner, name, label, sums, on)

    wrap(StreamingRing, "_slide_tables", "host: slide tables")
    wrap(streaming, "_pack", "host: pack the three buffers")
    wrap(StreamingRing, "_upload", "upload (pinned, asynchronous)")
    wrap(fixedlag, "assembly_plan", "assembly plan (once per slide)")
    wrap(step, "_build_and_solve",
         "build: IMU + assemble + solve_reduced (x2)")
    wrap(step, "_imu_eval", lambda p, c, u, jac, c9=None:
         "  IMU evaluate with Jacobians (x2 builds)" if jac
         else "  IMU evaluate without Jacobians (x2 trials)")
    wrap(step, "assemble", "  assemble (x2)")
    wrap(step, "solve_reduced", "  solve_reduced (x2)")
    wrap(step, "_cost", "trial cost (x2)")
    wrap(window, "marginalize", "marginalize")
    wrap(StreamingRing, "push", "push, whole")

    g = 0
    while ring._next_slide < n_warm:
        add_keyframe(ring, feed, g)
        ring.push(block=False)
        g += 1
    on[0] = True
    for _ in range(n_slides):
        add_keyframe(ring, feed, g)
        ring.push(block=False)
        g += 1
    on[0] = False
    for name, secs in sums.items():
        print(f"[{smi}] slide stage {name}: {secs / n_slides * 1e3:.2f} ms")

    sites = collections.Counter()
    root = str(chip_smoke.ROOT)

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if f.filename.startswith(root) and "profile_port" not in
                  f.filename]
        sites[" <- ".join(f"{Path(f.filename).relative_to(root)}:"
                          f"{f.lineno}" for f in frames[::-1][:3])] += 1

    add_keyframe(ring, feed, g)
    g += 1
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ring.push(block=False)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for site, n in sites.most_common():
        print(f"slide sync x{n}: {site}")

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            add_keyframe(ring, feed, g)
            ring.push(block=False)
            g += 1
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, ks = _busy_seconds(prof, "profile_slide.json", kernels={
        "K5 (schur_finish)": ("schur_mask_kernel", "schur_product_kernel"),
        "K11 (marginalize)": ("marginalize_kernel",)})
    print(f"[{smi}] profiled 2 pushes: wall {wall * 1e3:.1f} ms (profiler "
          f"on), device busy {busy * 1e3:.1f} ms = {100 * busy / wall:.2f}%"
          f"; per push: device busy {busy / 2 * 1e3:.3f} ms, "
          + ", ".join(f"{k} {v / 2 * 1e3:.4f} ms" for k, v in ks.items()))


def _wrap(owner, name, label, sums, on):
    """Replace owner.name by a wrapper that, while on[0], adds its seconds
    between two synchronizes to sums[label] (a callable label gets the
    call's arguments)."""
    import torch

    fn = getattr(owner, name)

    def timed(*a, **k):
        if not on[0]:
            return fn(*a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        key = label(*a, **k) if callable(label) else label
        sums[key] += time.perf_counter() - t0
        return out

    timed.__dict__.update(fn.__dict__)         # a kernel's launch count
    setattr(owner, name, timed)


def _stages(which):
    """(problem, config, [(owner, name, label)]) of `path_iteration`."""
    from ba_tpu_torch.kernels import fleet_schur
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import banded, cg, step

    imu = (step, "_imu_eval", lambda p, c, u, jac, c9=None:
           "IMU evaluate with Jacobians (K2 (a))" if jac
           else "  IMU evaluate without Jacobians (trial, K2 (b))")
    tail = [(cg, "back_substitute_blocks", "back-substitution (segsum)"),
            (cg, "cauchy_factor", "Cauchy factor (segsum)"),
            (step, "_cost", "trial cost (IMU, kernel 1, priors)"),
            (step, "gn_iteration", "gn_iteration, whole")]
    if which == "long":
        p, cfg, _ = chip_smoke.long_problem()
        mid = [(cg, "assemble_blocks", "assemble_blocks (kernel 1, segsum)"),
               (banded, "band_S", "band_S (segsum)"),
               (banded, "_band_schur_grouped", "  kernel 7"),
               (banded, "banded_pcg_solve", "factor + PCG, whole"),
               (banded, "chunk_layout", "  scaling and chunk layout (K8a)"),
               (banded, "chunk_factor", "  cyclic-reduction factor (K8b)"),
               (banded, "band_matvec", "  kernel 9 (4 per iteration)"),
               (banded, "chunk_solve", "  cyclic-reduction solves (5, K8c)")]
    elif which == "cg":
        p, cfg, _ = chip_smoke.cg_problem()
        mid = [(cg, "assemble_blocks",
                "assemble_blocks with the preconditioner (kernel 1, segsum)"),
               (cg, "pcg_solve", "PCG, whole"),
               (cg, "s_matvec", "  Schur products (kernel 6, segsum)"),
               (cg, "_precond", "  preconditioner")]
    elif which == "selfcal":
        _, p, cfg, _ = chip_smoke.selfcal_problem()
        cfg = dataclasses.replace(cfg, use_dogleg=False)
        mid = [(step, "assemble", "assemble, the general path with the "
                "calibration block (kernel 1, segsum)"),
               (asm, "proj_blocks", "  reprojection blocks (kernel 1 with "
                "the calibration columns)"),
               (asm, "seg_sum_groups", "  the build's ten sums (segsum)"),
               (asm, "finish", "  Schur complement (dense)"),
               (step, "solve_reduced", "solve_reduced (Cholesky of S, "
                "back-substitution)"),
               (step, "apply_update", "apply_update (calibration, "
                "re-unprojection)")]
        tail = tail[2:]
    else:
        p, cfg, _, _ = chip_smoke.fleet_problem()
        mid = [(cg, "assemble_blocks", "assemble_blocks (kernel 1, segsum)"),
               (banded, "solve_reduced_fleet_dense", "dense fleet solve, "
                "whole (with the back-substitution)"),
               (banded, "_band_self_cross", "  families' band (segsum)"),
               (fleet_schur, "fleet_w", "  kernel 10 (a)"),
               (fleet_schur, "fleet_epilogue", "  kernel 10 (b)"),
               (banded, "_chol", "  batched cholesky_ex"),
               (banded, "_cho_solve_b", "  triangular solves (2 x 2)")]
    return p, cfg, [imu] + mid + tail


def path_iteration(smi, which, n_iters=3):
    """Mean seconds per GN iteration of each stage of the long trajectory's
    banded solve, the PCG configuration's, the fused fleet's or the
    self-calibration's dense solve (a stage
    includes those nested in it), then the sync sites of one iteration and
    the busy share and kernel launches of one profiled iteration."""
    import torch
    from torch.profiler import ProfilerActivity

    from ba_tpu_torch.solver import step

    p, cfg, stages = _stages(which)
    plan = step.solve_plan(p, cfg)
    step.gn_iteration(p, cfg, True, plan=plan)                # warm-up
    sums = collections.defaultdict(float)
    on = [False]
    for owner, name, label in stages:
        _wrap(owner, name, label, sums, on)
    on[0] = True
    q = p
    for _ in range(n_iters):
        q = step.gn_iteration(q, cfg, True, plan=plan).problem
    on[0] = False
    for name, secs in sums.items():
        print(f"[{smi}] {which} stage {name}: {secs / n_iters * 1e3:.2f} ms")

    sites = collections.Counter()
    root = str(chip_smoke.ROOT)

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if f.filename.startswith(root) and "profile_port" not in
                  f.filename]
        sites[" <- ".join(f"{Path(f.filename).relative_to(root)}:"
                          f"{f.lineno}" for f in frames[::-1][:3])
              or "(no repository frame on the stack)"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step.gn_iteration(q, cfg, True, plan=plan)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()       # outside the window: it would count
    print(f"{which} iteration host syncs: {sum(sites.values())}")
    for site, n in sites.most_common():
        print(f"{which} sync x{n}: {site}")

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        step.gn_iteration(q, cfg, True, plan=plan)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, launches = _busy_seconds(prof, f"profile_{which}.json",
                                   count=True)
    print(f"[{smi}] profiled 1 {which} GN iteration: wall {wall * 1e3:.1f} "
          f"ms (profiler on), device busy {busy * 1e3:.1f} ms = "
          f"{100 * busy / wall:.2f}%, {launches} kernel launches")
    ka = prof.key_averages()
    dev_key = ("self_device_time_total"
               if hasattr(ka[0], "self_device_time_total")
               else "self_cuda_time_total")
    print(ka.table(sort_by=dev_key, row_limit=15))


def _busy_seconds(prof, name, count=False, kernels=None):
    """Sum of the kernel and copy spans of a profiler trace; with
    `kernels` ({label: name fragments}), also the seconds of the kernels
    whose names hold one of each label's fragments."""
    with tempfile.TemporaryDirectory(dir=chip_smoke.ROOT) as tmp:
        path = Path(tmp) / name
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    busy = 1e-6 * sum(e.get("dur", 0) for e in events
                      if e.get("cat") in ("kernel", "gpu_memcpy",
                                          "gpu_memset"))
    if kernels is not None:
        return busy, {label: 1e-6 * sum(
            e.get("dur", 0) for e in events if e.get("cat") == "kernel"
            and any(f in e.get("name", "") for f in frags))
            for label, frags in kernels.items()}
    if count:
        return busy, sum(e.get("cat") == "kernel" for e in events)
    return busy


def _build_other(src):
    """ctypes library of the CUDA source `src`, built with the package's
    nvcc line into its build directory."""
    import hashlib
    import subprocess

    from ba_tpu_torch.kernels import build

    src = Path(src).resolve()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"libother-{digest}.so"
    if not out.exists():
        subprocess.run([build._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(out),
                        str(src)], check=True)
    return ctypes.CDLL(str(out))


def k11_against(smi, src):
    """This tree's K11 and the one of `src` on the indefinite inputs of
    chip_smoke.py's k11 phase, f32 and f64: error against the plain
    version, info, ms per call and device ms."""
    import torch

    from ba_tpu_torch.kernels import marginalize as k11

    lib = _build_other(src)

    def other(S, rhs, pd, eps):
        fn = getattr(lib, {torch.float32: "ba_marginalize_f32",
                           torch.float64: "ba_marginalize_f64"}[S.dtype])
        fn.argtypes, fn.restype = k11._ARGTYPES, ctypes.c_int
        n = S.shape[0]
        H, g = torch.empty_like(S), torch.empty_like(rhs)
        info = torch.zeros((len(k11.INFO),), dtype=torch.int32,
                           device=S.device)
        work = torch.empty((3 * n * n,), dtype=S.dtype, device=S.device)
        rc = fn(S.data_ptr(), rhs.data_ptr(), pd.data_ptr(), n, float(eps),
                k11.MAX_SWEEPS, work.data_ptr(), H.data_ptr(), g.data_ptr(),
                info.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{src}: launch failed, CUDA error {rc}")
        return H, g, info

    cases = [("indefinite n=90", lambda dt: chip_smoke._random_departing(
        90, range(9), 0, dt))]
    cases += [(f"indefinite n={n}", lambda dt, n=n: chip_smoke
               .certificate_case("indefinite", n, dt)) for n in (169, 360)]
    for label, make in cases:
        for dt in (torch.float32, torch.float64):
            S, rhs, pd = make(dt)
            eps = 1e-9 if dt == torch.float64 else 1e-5
            Hp, gp = k11.marginalize_prior_plain(S, rhs, pd, eps)
            norm = float(torch.linalg.matrix_norm(Hp.double()))
            name = str(dt).split(".")[1]
            for who, fn in (("this tree", k11.marginalize_prior),
                            (str(src), other)):
                H, g, info = fn(S, rhs, pd, eps)
                torch.cuda.synchronize()
                err = max(float((H.double() - Hp.double()).abs().max()),
                          float((g.double() - gp.double()).abs().max()))
                ms = chip_smoke.event_ms(lambda: fn(S, rhs, pd, eps), 3)
                dev = chip_smoke.graph_ms(lambda: fn(S, rhs, pd, eps), 2,
                                          reps=2)
                print(f"[{smi}] K11 {label} {name}, {who}: {ms:.4f} ms per "
                      f"call ({dev:.4f} ms on the device); rel err "
                      f"{err / norm:.3e} (tol {chip_smoke.TOL_K11[name]:g});"
                      f" info {info.tolist()}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    smi = chip_smoke.smi_line()
    chip_smoke.phase_build()
    if "--k11-against" in sys.argv[1:]:
        k11_against(smi, sys.argv[sys.argv.index("--k11-against") + 1])
        return 0
    for which in ("long", "cg", "fleet", "selfcal"):
        if f"--{which}" in sys.argv[1:]:
            path_iteration(smi, which)
            return 0
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
    slide_stage_times(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
