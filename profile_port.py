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
preconditioner, the PCG with kernel 6's pack, its Schur products through
kernels 6 and 2 and the preconditioner, ...; then one Schur product split
into kernel 6, segsum and the glue, with the host and on the device, and
the pack's cost per build) or on its fused fleet (4 x 128 keyframes: the
families' band, kernel 10 (a) and (b), the batched Cholesky and the
triangular solves, ...).  With `--selfcal`, on chip_smoke.py's full-width
self-calibration configuration (128 keyframes, 15-dim states, 11
calibration columns, the general dense path: IMU through K2, kernel 1 with
the calibration columns, the assembly with its calibration block in one
segsum launch, the Cholesky of the 1,931-row S, the calibration update
with its re-unprojection, the trial cost).  With `--cg-selfcal`, on
chip_smoke.py's self-calibrating PCG (the PCG configuration under
<R,1,15,5,true>: the same stages as `--cg`, kernel 6 and its pack with the
11 calibration columns, and one Schur product split the same way).

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

With `--k8-levels [TREE]`, instead, it times K8b's cyclic-reduction
factor and one K8c solve on a system of the long trajectory's shape (one
window of 86 real chunks of n = 216 padded to 128, f32, made from a seed
on the card): device ms of a whole factor and a whole solve (CUDA-graph
replay) and of each level's eliminate, products, down and up steps
(chip_smoke.k8_level_split, from profiler traces).  With TREE (an
earlier tree unpacked under `_archive/`), the package is imported from
there, so PR 8's kernels are timed the same way in the same call:

    git archive <commit> | tar -x -C _archive/parent
    python3 profile_port.py --k8-levels _archive/parent
    python3 profile_port.py --k8-levels

With `--solves`, instead, it times chip_smoke.py's two flagship solves,
GN-25 (`solve_fixed`) and the dogleg `solve` (f32, at most 25 iterations),
five times each after a warm-up, and prints each run's iterations, its
cost-only IMU evaluations (K2 (b) launches: one per trial, one for the
error breakdown), its wall time, its keyframes per second and its wall
time per IMU evaluation.  To set it beside an earlier tree's (unpacked
under `_archive/`, which git ignores), run this file from that tree's
root, so that `chip_smoke` and the package resolve there:

    cd _archive/parent && python3 -c "import runpy, sys; \
        sys.argv = ['profile_port.py', '--solves']; \
        runpy.run_path('../../profile_port.py', run_name='__main__')"

With `--gps`, instead, the stages of one push of chip_smoke.py's GPS
stream (the smoother's fixed-lag ring, W = 10, f64), the device's busy
share of two profiled pushes, and the host operators with the most self
time in them.

    python3 profile_port.py --gps

With `--gps-drift`, instead, the card's GPS streams (chip_smoke.py's
`gps_small` and `gps_stream`, f64) against the CPU's, slide by slide,
beside the CPU's own streams with their priors moved by about an ulp and
with the priors K11's certificate returns (three CPU worker processes;
~10 min).

    python3 profile_port.py --gps-drift

With `--mesh [N]`, instead, chip_smoke.py's phases `mesh_small`, `mesh`
and `fleet_mesh` on N spawned ranks (N defaults to the card count): each
rank on a card of its own over NCCL where the machine has N cards, else
sharing `cuda:0` over gloo (`ba_tpu_torch/parallel/mesh.py:backend_for`).
Every route in f64 against the CPU; the flagship, the PCG cell and the
long trajectory at full width in f32 with ms per iteration on the N
ranks and at one rank, collectives per iteration and their share;
`fleet_serve --mesh N` and the serving rings, bit for bit against one
rank:

    python3 profile_port.py --mesh 4     # a machine with four cards

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

# `--k8-levels TREE` times the package of TREE: it goes first on the path
# before anything imports ba_tpu_torch
K8_TREE = None
if "--k8-levels" in sys.argv[1:]:
    _i = sys.argv.index("--k8-levels") + 1
    if _i < len(sys.argv) and not sys.argv[_i].startswith("--"):
        K8_TREE = sys.argv[_i]
        sys.path.insert(0, str(Path(K8_TREE).resolve()))

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


def gps_slide_stage_times(smi, n_warm=3, n_slides=5):
    """`slide_stage_times` on chip_smoke.py's GPS stream (W = 10, f64,
    lm_size 0, the app's `run_streaming`): mean ms per push of each stage,
    then the device's busy share of two profiled pushes, the kernels'
    device ms per push and the host operators with the most self time."""
    import torch
    from torch.profiler import ProfilerActivity

    from ba_tpu_torch.apps import unary_binary_imu_test as app
    from ba_tpu_torch.core.residuals import prior
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import fixedlag, step, streaming, window
    from ba_tpu_torch.solver.streaming import StreamingRing

    W = chip_smoke.GPS["window"]
    with tempfile.TemporaryDirectory(dir=chip_smoke.ROOT) as tmp:
        path = str(Path(tmp) / "gps.txt")
        app.generate_log(path, n_gps=W + n_warm + n_slides + 3,
                         noise_gps=chip_smoke.GPS["noise"])
        imu, gps, gu, _ = app.parse_log(path)
    sums = collections.defaultdict(float)
    on = [False]
    for owner, name, label in (
            (StreamingRing, "_slide_tables", "host: slide tables"),
            (streaming, "_pack", "host: pack the three buffers"),
            (StreamingRing, "_upload", "upload (pinned, asynchronous)"),
            (fixedlag, "assembly_plan", "assembly plan (once per slide)"),
            (step, "_build_and_solve",
             "build: IMU + assemble + solve_reduced (x6)"),
            (step, "_imu_eval", lambda p, c, u, jac, c9=None:
             "  IMU evaluate with Jacobians (x6 builds)" if jac
             else "  IMU evaluate without Jacobians (x6 trials)"),
            (step, "assemble", "  assemble (x6)"),
            (asm, "proj_blocks", "    K1 blocks (lm_size 0)"),
            (prior, "evaluate_unary", lambda p, c, with_jacobians=True:
             "    unary priors with Jacobians" if with_jacobians
             else "    unary priors, residuals only"),
            (prior, "evaluate_binary", lambda p, c, with_jacobians=True:
             "    binary priors with Jacobians" if with_jacobians
             else "    binary priors, residuals only"),
            (asm, "seg_sum_groups", "    grouped segment sums"),
            (asm, "marg_contribution", "    the prior's rows"),
            (asm, "finish", "    Schur step (K5) and finish"),
            (step, "solve_reduced", "  solve_reduced (x6)"),
            (step, "_cost", "trial cost (x6)"),
            (window, "marginalize", "marginalize"),
            (StreamingRing, "push", "push, whole")):
        _wrap(owner, name, label, sums, on)
    prof = torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    slides = []
    clock = {}

    def on_push(g, out):
        if out is None:
            return
        slides.append(g)
        k = len(slides)
        if k == n_warm:
            on[0] = True
        elif k == n_warm + n_slides:
            on[0] = False
            torch.cuda.synchronize()
            prof.start()
            clock["t0"] = time.perf_counter()
        elif k == n_warm + n_slides + 2:
            torch.cuda.synchronize()
            clock["wall"] = time.perf_counter() - clock["t0"]
            prof.stop()

    app.run_streaming(imu, gps, gu, W, iters_per_slide=chip_smoke.GPS[
        "iters"], device="cuda", on_push=on_push)
    for name, secs in sums.items():
        print(f"[{smi}] GPS push stage {name}: "
              f"{secs / n_slides * 1e3:.2f} ms")
    busy, ks = _busy_seconds(prof, "profile_gps.json", kernels={
        "K1 (reprojection)": ("reproj",),
        "K2 (imu_preint)": ("imu_preint",),
        "K5 (schur_finish)": ("schur_mask_kernel", "schur_product_kernel"),
        "K11 (marginalize)": ("marginalize_kernel",)})
    wall = clock["wall"]
    print(f"[{smi}] GPS profiled 2 pushes: wall {wall * 1e3:.1f} ms "
          f"(profiler on), device busy {busy * 1e3:.1f} ms = "
          f"{100 * busy / wall:.2f}%; per push: device busy "
          f"{busy / 2 * 1e3:.3f} ms, "
          + ", ".join(f"{k} {v / 2 * 1e3:.4f} ms" for k, v in ks.items()))
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in ops[:15]:
        print(f"GPS push host op {e.key}: {e.count / 2:g} calls, "
              f"{e.self_cpu_time_total / 2e3:.2f} ms self per push")


def _gps_cpu_stream(job):
    """The GPS stream of `job` = (log path, fixes, W, mode) on the CPU, in
    f64 (a worker process): the retired outputs as numpy.  `mode` sets the
    prior that each marginalization returns: "plain" (the `eigh` clip),
    "certified" (the symmetrized H unclipped whenever an f64 Cholesky of
    its active block + tau I succeeds, tau = 1e-12 ||H||_F: K11's
    certified branch) or "ulp" (the plain prior with each entry moved by
    a relative 1e-16 of symmetric seeded noise: about an ulp).  Returns
    (outputs, [(certified, smallest eigenvalue of the prior's active block
    / ||H||_F) per marginalization] in the "certified" mode, else [])."""
    import numpy as np
    import torch

    from ba_tpu_torch.apps import unary_binary_imu_test as app
    from ba_tpu_torch.kernels import marginalize as k11

    path, fixes, W, mode = job
    torch.set_num_threads(1)
    plain = k11.marginalize_prior_plain
    rng = np.random.default_rng(0)
    stats = []

    def prior(S, rhs, pd, eps):
        H, g = plain(S, rhs, pd, eps)
        if mode == "ulp":
            E = torch.as_tensor(rng.standard_normal(H.shape))
            return H * (1 + 1e-16 * 0.5 * (E + E.T)), g
        if mode == "certified":
            Pd = pd.to(S.dtype)
            Bm = (S * Pd[:, None] * Pd[None, :] + torch.diag(1.0 - Pd)
                  + eps * torch.diag(Pd))
            Binv = torch.linalg.inv_ex(Bm).inverse * Pd[:, None] * Pd[None, :]
            SP = S * Pd[None, :]
            keep = 1.0 - Pd
            Hu = (S - SP @ Binv @ SP.T) * keep[:, None] * keep[None, :]
            Hu = 0.5 * (Hu + Hu.T)
            act = Hu.abs().sum(1) != 0
            Ha = Hu[act][:, act]
            fro = torch.linalg.norm(Hu)
            eye = torch.eye(Ha.shape[0], dtype=Ha.dtype)
            ok = torch.linalg.cholesky_ex(Ha + 1e-12 * fro * eye).info == 0
            stats.append((bool(ok), float(torch.linalg.eigvalsh(Ha)[0]
                                          / fro)))
            if ok:
                return Hu, g
        return H, g

    k11.marginalize_prior_plain = prior
    imu, gps, gu, _ = app.parse_log(path)
    outs, _ = app.run_streaming(imu, gps[:fixes], gu[:fixes], W,
                                device="cpu")
    return outs, stats


def gps_drift(smi):
    """How far the card's GPS stream (f64) lies from the CPU's, slide by
    slide, beside how far the CPU's own stream moves when its priors move
    by about an ulp ("ulp") or are returned as K11's certificate returns
    them ("certified"): chip_smoke.py's `gps_stream` (the first 120 of
    600 fixes, W = 10) and `gps_small` (16 fixes, W = 10), and the first
    8 of those 16 fixes with W = 4.  The CPU streams run in
    worker processes (one thread each) beside the card's."""
    import multiprocessing

    import torch

    from ba_tpu_torch.apps import unary_binary_imu_test as app

    small = chip_smoke.GPS_SMALL
    runs = (("gps_stream", chip_smoke.GPS["fixes"],
             chip_smoke.GPS["stream_fixes"], chip_smoke.GPS["window"]),
            ("gps_small", small["fixes"], small["stream_fixes"],
             small["window"]),
            ("gps_small_w4", small["fixes"], 8, 4))
    modes = ("plain", "certified", "ulp")
    with tempfile.TemporaryDirectory(dir=chip_smoke.ROOT) as tmp:
        jobs = []
        for name, n_log, fixes, W in runs:
            path = str(Path(tmp) / f"{name}.txt")
            app.generate_log(path, n_gps=n_log,
                             noise_gps=chip_smoke.GPS["noise"])
            jobs += [(path, fixes, W, m) for m in modes]
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(2 * len(modes)) as pool:
            cpu = pool.map_async(_gps_cpu_stream, jobs, chunksize=1)
            card = {}
            for (name, _, fixes, W) in runs:
                imu, gps, gu, _ = app.parse_log(str(Path(tmp) /
                                                    f"{name}.txt"))
                t0 = time.perf_counter()
                card[name], _ = app.run_streaming(imu, gps[:fixes],
                                                  gu[:fixes], W)
                torch.cuda.synchronize()
                print(f"[{smi}] {name} stream on the card: "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            cpu = cpu.get()
    for r, (name, _, fixes, W) in enumerate(runs):
        (plain, _), (cert, stats), (ulp, _) = cpu[3 * r:3 * r + 3]
        lam = min(v for _, v in stats)
        print(f"{name}: the CPU's priors certified {sum(c for c, _ in stats)}"
              f" of {len(stats)}; smallest eigenvalue of an active block "
              f"{lam:.3e} ||H||_F (tau 1e-12 ||H||_F), "
              f"{sum(v < 0 for _, v in stats)} priors with a negative one")
        worst = collections.defaultdict(float)
        for k, (a, b) in enumerate(zip(card[name], plain)):
            errs = []
            for label, o in (("card", a), ("certified", cert[k]),
                             ("ulp", ulp[k])):
                e = {f: chip_smoke.rel_err(
                    torch.as_tensor(o[f]).double(),
                    torch.as_tensor(b[f]).double())[1]
                    for f in ("q", "t", "cost")}
                worst[label] = max(worst[label], max(e.values()))
                errs.append(f"{label} " + " ".join(
                    f"{f} {v:.2e}" for f, v in e.items()))
            print(f"{name} (W = {W}) slide {k} rel err to the CPU: "
                  + "; ".join(errs))
        print(f"[{smi}] {name} ({fixes} fixes, W = {W}, "
              f"{len(plain)} slides) worst rel err to the CPU stream: "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


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
    from ba_tpu_torch.kernels import schur_matvec as k6
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import banded, cg, step

    imu = (step, "_imu_eval", lambda p, c, u, jac, c9=None:
           "IMU evaluate with Jacobians (K2 (a), whitened)" if jac
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
    elif which in ("cg", "cg_selfcal"):
        if which == "cg":
            p, cfg, _ = chip_smoke.cg_problem()
        else:
            p, _, cfg, _ = chip_smoke.cg_selfcal_problem()
        mid = [(cg, "assemble_blocks",
                "assemble_blocks with the preconditioner (kernel 1, segsum)"),
               (k6, "schur_pack", "  kernel 6's pack (once per build)"),
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
               (fleet_schur, "fleet_schur", "  kernel 10 (the scaled Schur "
                "system)"),
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


def schur_product_split(smi, which="cg"):
    """One Schur product of the PCG configuration (`cg.s_matvec`, f32;
    with `which` "cg_selfcal" the self-calibrating PCG's) split into
    kernel 6, segsum's launch and the glue (the masks, the unary and
    binary rows, the pad, the damping: plain torch), each with the host
    (CUDA events around 100 calls) and on the device (CUDA-graph replay),
    the glue as the whole less the two kernels; the device operations of
    one product; and kernel 6's pack, once per build."""
    import numpy as np
    import torch

    if which == "cg":
        p, cfg, _ = chip_smoke.cg_problem()
    else:
        p, _, cfg, _ = chip_smoke.cg_selfcal_problem()
    bs = chip_smoke.cg_blocks(p, cfg)
    P, D = p.poses.q.shape[0], cfg.pose_dim
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        P * D + cfg.calib_dim), dtype=torch.float32, device="cuda")
    parts = chip_smoke.schur_product_parts(bs, x, P, D, cfg.lm_size)[0]
    t = {k: (chip_smoke.event_ms(f, 100), chip_smoke.graph_ms(f, 20))
         for k, f in parts.items()}
    t["glue (the rest)"] = tuple(
        t["whole product"][i] - t["kernel 6"][i] - t["segsum"][i]
        for i in range(2))
    for k, (ms, dev) in t.items():
        print(f"[{smi}] {which} Schur product: {k} {ms:.4f} ms with the "
              f"host, {dev:.4f} ms on the device"
              + (" (once per build)" if k == "pack" else ""))
    ops = chip_smoke._device_ops(parts["whole product"])
    print(f"{which} Schur product: {ops} device operations per product "
          f"(kernel 6, segsum and the glue's)")


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


def k8_system(n_c=86, chunk=24, D=9, seed=0):
    """(Dg, Eg, rows, n_c): one window of the long trajectory's chunk shape
    (n_c real chunks of n = chunk D, padded with identity chunks and zero
    couplings to a power of two, as K8a lays them out), f32 on the card:
    symmetric diagonal blocks made dominant, couplings ~0.05, from a seed;
    rows (1, n_c n - 3) of ones."""
    import torch

    n = chunk * D
    m = 1 << (n_c - 1).bit_length()
    g = torch.Generator(device="cuda").manual_seed(seed)
    Dg = 0.05 * torch.randn((1, m, n, n), generator=g, device="cuda")
    Dg = Dg + Dg.mT + (0.1 * n + 2.0) * torch.eye(n, device="cuda")
    Eg = 0.05 * torch.randn((1, m, n, n), generator=g, device="cuda")
    Dg[:, n_c:] = torch.eye(n, device="cuda")
    Eg[:, n_c:] = 0.0
    return Dg, Eg, torch.ones((1, n_c * n - 3), device="cuda"), n_c


def k8_levels(smi, tree):
    """K8b and K8c of the package first on sys.path (this tree's, or
    TREE's) on `k8_system`: device ms of a factor and a solve, and their
    split by level and stage."""
    import inspect

    from ba_tpu_torch.kernels import chunk_tridiag as k8

    Dg, Eg, rows, n_c = k8_system()
    kw = ({"live": n_c} if "live" in inspect.signature(
        k8.bcr_factor).parameters else {})
    levels, ok = k8.bcr_factor(Dg, Eg, **kw)
    x = k8.bcr_solve(levels, rows)
    who = tree or "this tree"
    print(f"[{smi}] K8 on the long trajectory's shape ({who}): ok "
          f"{bool(ok)}, x finite {bool(x.isfinite().all())}", flush=True)
    tf = chip_smoke.graph_ms(lambda: k8.bcr_factor(Dg, Eg, **kw), 3)
    ts = chip_smoke.graph_ms(lambda: k8.bcr_solve(levels, rows), 10)
    split = chip_smoke.k8_level_split(lambda: k8.bcr_factor(Dg, Eg, **kw),
                                      lambda: k8.bcr_solve(levels, rows),
                                      len(levels) - 1)

    def row(xs):
        return " ".join(f"{v:.4f}" for v in xs)

    print(f"[{smi}] K8 ({who}) device ms: factor {tf:.4f}, solve {ts:.4f} "
          f"(CUDA-graph replay); by level (profiler, mean of 3 calls), "
          f"factor eliminate {row(split['eliminate'])}, base "
          f"{split['base_eliminate']:.4f}; factor products "
          f"{row(split['products'])}; solve down {row(split['down'])}, "
          f"base {split['base_solve']:.4f}, up {row(split['up'])}; sums "
          f"factor {split['factor_total']:.4f}, solve "
          f"{split['solve_total']:.4f}", flush=True)


def solve_times(smi, n_solves=5):
    """GN-25 and the dogleg solve on the flagship: n_solves timed runs of
    each after a warm-up."""
    import torch

    from ba_tpu_torch.kernels import imu_preint
    from ba_tpu_torch.solver import step

    _, p, cfg, _ = chip_smoke.flagship()
    n = chip_smoke.N_ITERS
    for name, run in (
            ("GN-25", lambda: step.solve_fixed(
                p, dataclasses.replace(cfg, use_dogleg=False), True, n)),
            ("dogleg", lambda: step.solve(
                p, dataclasses.replace(cfg, use_dogleg=True), max_iter=n))):
        run()
        torch.cuda.synchronize()
        for k in range(n_solves):
            ia = imu_preint.imu_full.launches
            ib = imu_preint.imu_residual.launches
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            iters = n if name == "GN-25" else out[1].iterations
            na = imu_preint.imu_full.launches - ia
            nb = imu_preint.imu_residual.launches - ib
            print(f"[{smi}] {name} run {k}: {iters} iterations, K2 (a) "
                  f"{na} (b) {nb}, {secs * 1e3:.1f} ms, "
                  f"{chip_smoke.N_POSES * iters / secs:.1f} kf/s, "
                  f"{secs * 1e3 / (na + nb):.2f} ms per IMU evaluation",
                  flush=True)


def flagship_dogleg_iters():
    """The iterations of the flagship's default dogleg `solve` in f32 on
    the card: chip_smoke.py's phase 7, whose count its mesh phase runs."""
    import torch

    from ba_tpu_torch.solver import step

    _, p32, cfg, _ = chip_smoke.flagship()
    _, s = step.solve(p32, dataclasses.replace(cfg, use_dogleg=True),
                      max_iter=chip_smoke.N_ITERS)
    torch.cuda.synchronize()
    return s.iterations


def mesh_phases(smi, n):
    """chip_smoke.py's mesh phases on n ranks (see the module docstring)."""
    chip_smoke.phase_mesh_small(smi, n)
    chip_smoke.phase_mesh(smi, flagship_dogleg_iters(), size=n)
    chip_smoke.phase_fleet_mesh(smi, n)


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    smi = chip_smoke.smi_line()
    if "--k8-levels" in sys.argv[1:]:
        k8_levels(smi, K8_TREE)
        return 0
    chip_smoke.phase_build()
    if "--k11-against" in sys.argv[1:]:
        k11_against(smi, sys.argv[sys.argv.index("--k11-against") + 1])
        return 0
    if "--solves" in sys.argv[1:]:
        solve_times(smi)
        return 0
    if "--gps" in sys.argv[1:]:
        gps_slide_stage_times(smi)
        return 0
    if "--gps-drift" in sys.argv[1:]:
        gps_drift(smi)
        return 0
    if "--mesh" in sys.argv[1:]:
        i = sys.argv.index("--mesh") + 1
        n = (int(sys.argv[i]) if i < len(sys.argv)
             and not sys.argv[i].startswith("--")
             else torch.cuda.device_count())
        mesh_phases(smi, n)
        return 0
    for which in ("long", "cg", "fleet", "selfcal", "cg_selfcal"):
        if f"--{which.replace('_', '-')}" in sys.argv[1:]:
            path_iteration(smi, which)
            if which == "long":
                k8_levels(smi, None)
            if which in ("cg", "cg_selfcal"):
                schur_product_split(smi, which)
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
