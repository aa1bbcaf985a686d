#!/usr/bin/env python3
"""Where a Gauss-Newton iteration, a streaming slide and a benchmark cell
of the port spend their time on the card, read from the program's own
spans and counters (`ba_tpu_torch/utils/timing.py`).

    python3 profile_port.py

On the flagship problem of chip_smoke.py (128 keyframes, f32, band width
24) it prints:

  * the program's spans over a few `gn_iteration`s (`timing.report`:
    calls, host and stream seconds, self seconds, host-read seconds);
  * the source lines that synchronize the host with the device, found with
    PyTorch's sync debug mode;
  * the device's busy share of two profiled iterations, its idle seconds
    by the program span open on the host when each idle gap began
    (`timing.attribute`), and the operators with the most device time and
    the most host time under `torch.profiler`;

then the same for `StreamingRing.push` on chip_smoke.py's stream (W = 10,
2 GN iterations per slide, f32): the spans of five pushes after a
warm-up, the sync sites of a push, and two profiled pushes with K5's and
K11's device time per push.

With `--long`, `--cg`, `--fleet`, `--selfcal` or `--cg-selfcal`, instead,
the same for a GN iteration of chip_smoke.py's long trajectory (2,048
keyframes, f32, band width 24, the banded solver; then K8 level by level
as `--k8-levels`), its PCG configuration (1,024 keyframes,
`use_cg_solver`; then one Schur product split into kernel 6, segsum and
the glue, with the host and on the device, and the pack's cost per
build), its fused fleet (4 x 128 keyframes), its full-width
self-calibration (128 keyframes, 15-dim states, 11 calibration columns,
the general dense path) or its self-calibrating PCG (the PCG
configuration under <R,1,15,5,true>, the Schur product split the same
way).

With `--cell NAME [--seed N]`, instead, a benchmark cell's problem
(`portbench/`, built from the seed as a run builds it): whole solves with
tracing off and under `timing.enable()` in turns (four pairs: the
tracing's cost), a span site's host cost, the sync sites of a solve off
and on, and a profiled phase as the benchmark's traced run makes one,
read through the program's spans: the share of the `iteration` spans'
host and stream time their child spans cover, the `solve` spans' stream
time against the phase's wall time, the cell's per-layer metrics of the
program's spans and counters, and the idle seconds by span.

    python3 profile_port.py --cell bal-venice.gn-pcg --seed 7

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

With `--gps`, instead, the program's spans over five pushes of
chip_smoke.py's GPS stream (the smoother's fixed-lag ring, W = 10, f64),
the device's busy share and idle seconds by span of two profiled pushes,
and the host operators with the most self time in them.

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
import contextlib
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

N_ITERS = 5              # iterations (or pushes) under the spans
N_PROFILE_ITERS = 2      # iterations (or pushes) under the profiler


def _sync_sites(run):
    """Counter of the innermost repository frames of each synchronizing
    operation of `run()`, found with PyTorch's sync debug mode."""
    import torch

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
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()       # outside the window: it would count
    return sites


def _print_sync_sites(label, sites):
    print(f"{label} host syncs: {sum(sites.values())}")
    for site, n in sites.most_common():
        print(f"{label} sync x{n}: {site}")


def _spans(run, n, label):
    """The program's spans (`timing.report`) over n calls of `run()` under
    `timing.enable()`."""
    import torch

    from ba_tpu_torch.utils import timing

    timing.reset()
    with timing.enable():
        for _ in range(n):
            run()
    torch.cuda.synchronize()
    print(f"{label}: the program's spans over {n}\n{timing.report()}")
    timing.reset()


def _profiled(run, n, label, smi, kernels=None):
    """n calls of `run()` under `torch.profiler`: the wall time, the
    device's busy share and launches (with `kernels`, those kernels'
    seconds a call), and the device's idle seconds by the program span
    open on the host when each gap began.  Returns the profiler."""
    import torch
    from torch.profiler import ProfilerActivity

    from ba_tpu_torch.utils import timing

    timing.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, launches, ks = _busy_seconds(prof, f"profile_{label}.json",
                                       kernels or {})
    print(f"[{smi}] profiled {n} x {label}: wall {wall * 1e3:.1f} ms "
          f"(profiler on), device busy {busy * 1e3:.1f} ms = "
          f"{100 * busy / wall:.2f}%, {launches} kernel launches; per call: "
          f"device busy {busy / n * 1e3:.3f} ms"
          + "".join(f", {k} {v / n * 1e3:.4f} ms" for k, v in ks.items()))
    print(f"{label} device idle by program span (s): " + ", ".join(
        f"{k} {v:.6f}" for k, v in timing.attribute(prof).items()))
    timing.reset()
    return prof


def _op_tables(prof, rows=20, host=True):
    ka = prof.key_averages()
    dev_key = ("self_device_time_total"
               if hasattr(ka[0], "self_device_time_total")
               else "self_cuda_time_total")
    print(ka.table(sort_by=dev_key, row_limit=rows))
    if host:
        print(ka.table(sort_by="self_cpu_time_total", row_limit=rows))


def flagship_iteration(smi):
    """The program's spans over N_ITERS GN iterations of the flagship, the
    sync sites of one, and N_PROFILE_ITERS profiled."""
    from ba_tpu_torch.solver import step

    _, p, cfg, _ = chip_smoke.flagship()
    cfg = dataclasses.replace(cfg, use_dogleg=False)
    plan = step.solve_plan(p, cfg)

    def run():
        step.gn_iteration(p, cfg, True, plan=plan)

    run()                                                    # warm-up
    _spans(run, N_ITERS, "flagship GN iteration")
    _print_sync_sites("flagship iteration", _sync_sites(run))
    _op_tables(_profiled(run, N_PROFILE_ITERS, "flagship_gn", smi))


def _push_slides(ring, feed, g, n, add_keyframe):
    for _ in range(n):
        add_keyframe(ring, feed, g)
        ring.push(block=False)
        g += 1
    return g


def slide_profile(smi, n_warm=3):
    """The program's spans over N_ITERS pushes of chip_smoke.py's stream
    after a warm-up, the sync sites of a push, and two profiled pushes
    with K5's and K11's device time."""
    import numpy as np

    from ba_tpu_torch.apps.vins_stream import (add_keyframe, stream_feed,
                                               stream_problem)
    from ba_tpu_torch.solver import fixedlag
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
    g = _push_slides(ring, feed, 0, W - 1 + n_warm, add_keyframe)
    state = {"g": g}

    def run(n=1):
        state["g"] = _push_slides(ring, feed, state["g"], n, add_keyframe)

    _spans(lambda: run(N_ITERS), 1, f"{N_ITERS} stream pushes")
    _print_sync_sites("slide", _sync_sites(run))
    _profiled(lambda: run(2), 1, "stream_2_pushes", smi, kernels={
        "K5 (schur_finish)": ("schur_mask_kernel", "schur_product_kernel"),
        "K11 (marginalize)": ("marginalize_kernel",)})


def gps_slide_profile(smi, n_warm=3, n_slides=5):
    """`slide_profile` on chip_smoke.py's GPS stream (W = 10, f64,
    lm_size 0, the app's `run_streaming`): the program's spans over
    n_slides pushes, then two profiled pushes with the kernels' device
    time and the host operators with the most self time."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity

    from ba_tpu_torch.apps import unary_binary_imu_test as app
    from ba_tpu_torch.utils import timing

    W = chip_smoke.GPS["window"]
    with tempfile.TemporaryDirectory(dir=chip_smoke.ROOT) as tmp:
        path = str(Path(tmp) / "gps.txt")
        app.generate_log(path, n_gps=W + n_warm + n_slides + 3,
                         noise_gps=chip_smoke.GPS["noise"])
        imu, gps, gu, _ = app.parse_log(path)
    prof = torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    slides = []
    clock = {}
    spans = contextlib.ExitStack()

    def on_push(g, out):
        if out is None:
            return
        slides.append(g)
        k = len(slides)
        if k == n_warm:
            timing.reset()
            spans.enter_context(timing.enable())
        elif k == n_warm + n_slides:
            spans.close()
            torch.cuda.synchronize()
            print(f"GPS: the program's spans over {n_slides} pushes\n"
                  f"{timing.report()}")
            timing.reset()
            prof.start()
            clock["t0"] = time.perf_counter()
        elif k == n_warm + n_slides + 2:
            torch.cuda.synchronize()
            clock["wall"] = time.perf_counter() - clock["t0"]
            prof.stop()

    app.run_streaming(imu, gps, gu, W, iters_per_slide=chip_smoke.GPS[
        "iters"], device="cuda", on_push=on_push)
    busy, launches, ks = _busy_seconds(prof, "profile_gps.json", {
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
    print("GPS device idle by program span (s): " + ", ".join(
        f"{k} {v:.6f}" for k, v in timing.attribute(prof).items()))
    timing.reset()
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


def _path_problem(which):
    """(problem, config) of `path_iteration`'s configuration."""
    if which == "long":
        p, cfg, _ = chip_smoke.long_problem()
    elif which == "cg":
        p, cfg, _ = chip_smoke.cg_problem()
    elif which == "cg_selfcal":
        p, _, cfg, _ = chip_smoke.cg_selfcal_problem()
    elif which == "selfcal":
        _, p, cfg, _ = chip_smoke.selfcal_problem()
        cfg = dataclasses.replace(cfg, use_dogleg=False)
    else:
        p, cfg, _, _ = chip_smoke.fleet_problem()
    return p, cfg


def path_iteration(smi, which, n_iters=3):
    """The program's spans over n_iters GN iterations of the long
    trajectory's banded solve, the PCG configuration's, the fused fleet's
    or the self-calibration's dense solve, then the sync sites of one
    iteration and one profiled iteration."""
    from ba_tpu_torch.solver import step

    p, cfg = _path_problem(which)
    plan = step.solve_plan(p, cfg)
    state = {"q": p}

    def run():
        state["q"] = step.gn_iteration(state["q"], cfg, True,
                                       plan=plan).problem

    run()                                                    # warm-up
    _spans(run, n_iters, f"{which} GN iteration")
    _print_sync_sites(f"{which} iteration", _sync_sites(run))
    _op_tables(_profiled(run, 1, which, smi), rows=15, host=False)


def cell_trace(smi, name, seed, pairs=4):
    """A benchmark cell's whole solves (`portbench/`, the problem built
    from `seed` as a run builds it): tracing off and under
    `timing.enable()` in turns, `pairs` of each, after a warm-up solve of
    each (the first traced solve fills the event pool), and a span site's
    host cost off and on; the sync sites of a solve off and on; then a
    profiled phase as the traced run's, read through the program's
    spans."""
    import importlib
    import statistics

    import torch

    from ba_tpu_torch.utils import timing
    from portbench import harness, trace

    cl = harness.cell(name)
    scene = importlib.import_module(
        f"portbench.scenes.{cl.config['scene']}").generate(
            cl.config, cl.mix, seed, "cuda")
    dtype = getattr(torch, cl.config["solver"].get("dtype", "float32"))
    prog = cl.entry.setup(scene.rounded(dtype), cl, "cuda")
    del scene

    def solve():
        return cl.entry.solve(prog)[1]        # its GN iterations

    solve()                                   # loads or builds the kernels
    with timing.enable():                     # fills the event pool
        solve()
    x, cost = torch.ones(1, device="cuda"), {}
    for mode in ("off", "on"):
        with timing.enable() if mode == "on" else contextlib.nullcontext():
            t0 = time.perf_counter()
            for _ in range(10000):
                with timing.span("site", x):
                    pass
            cost[mode] = (time.perf_counter() - t0) * 1e2   # us a site
        timing.reset()
    print(f"[{smi}] a span site costs {cost['off']:.3f} us of host off, "
          f"{cost['on']:.3f} us on (two events)")
    ms = {"off": [], "on": []}
    for k in range(pairs):
        for mode in ("off", "on") if k % 2 == 0 else ("on", "off"):
            timing.reset()
            t0 = time.perf_counter()
            with timing.enable() if mode == "on" else contextlib.nullcontext():
                solve()
            ms[mode].append(1e3 * (time.perf_counter() - t0))
            print(f"[{smi}] {name} seed {seed} pair {k} tracing {mode}: "
                  f"solve {ms[mode][-1]:.2f} ms", flush=True)
    off, on = statistics.median(ms["off"]), statistics.median(ms["on"])
    print(f"[{smi}] {name} solve_ms medians: off {off:.2f}, on {on:.2f} "
          f"({100 * (on / off - 1):+.2f} %)")
    timing.reset()
    sites_off = _sync_sites(solve)
    with timing.enable():
        sites_on = _sync_sites(solve)
    timing.reset()
    _print_sync_sites(f"{name} solve, tracing off", sites_off)
    _print_sync_sites(f"{name} solve, tracing on", sites_on)
    extra = sites_on - sites_off
    print(f"{name}: sync sites of the traced solve beyond the untraced "
          f"one's: {dict(extra) or 'none'}")

    iters = [0]

    def run():
        iters[0] += solve()

    window, calls, prof = trace.profile(run, harness.PROFILE_SECONDS)
    rec = trace.read(prof, window)
    s = timing.summary()
    sp = s["spans"]
    print(f"[{smi}] {name} profiled phase: {calls} solves, {iters[0]} "
          f"iterations, {window:.3f} s, device idle "
          f"{100 * (1 - rec['busy_s'] / window):.2f} %\n{timing.report()}")
    it = sp["iteration"]
    print(f"{name}: the iteration spans' children cover "
          f"{100 * (1 - it['self_s'] / it['host_s']):.2f} % of their host "
          f"time and {100 * (1 - it['stream_self_s'] / it['stream_s']):.2f} "
          f"% of their stream time; the solve spans' stream time "
          f"{sp['solve']['stream_s']:.4f} s is "
          f"{100 * sp['solve']['stream_s'] / window:.2f} % of the phase's "
          f"wall time")
    if "reduced.cg" in sp:
        n, c = sp["reduced.cg"]["calls"], s["counters"]
        print(f"{name}: pcg.iterations per reduced.cg span "
              f"{c['pcg.iterations'] / n:g}, pcg.products per span "
              f"{c['pcg.products'] / n:g}")
    ctx = dict(trace=dict(rec, iterations=iters[0]))
    for m in cl.per_layer:
        r = importlib.import_module(f"portbench.metrics.{m['name']}")
        if hasattr(r, "program_summary"):     # reads the program's store
            print(f"{name} metric {m['name']}: {r.read(ctx)}")
    idle = timing.attribute(prof)
    tot = sum(idle.values())
    print(f"[{smi}] {name} device idle by program span (s, of {tot:.4f}): "
          + ", ".join(f"{k} {v:.6f} ({100 * v / tot:.1f} %)"
                      for k, v in idle.items()))
    timing.reset()


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


def _busy_seconds(prof, name, kernels):
    """(busy seconds, kernel launches, {label: seconds}) of a profiler
    trace: the sum of its kernel and copy spans, its kernel spans, and the
    seconds of the kernels whose names hold one of each label's
    fragments."""
    with tempfile.TemporaryDirectory(dir=chip_smoke.ROOT) as tmp:
        path = Path(tmp) / name
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    busy = 1e-6 * sum(e.get("dur", 0) for e in events
                      if e.get("cat") in ("kernel", "gpu_memcpy",
                                          "gpu_memset"))
    return busy, sum(e.get("cat") == "kernel" for e in events), {
        label: 1e-6 * sum(e.get("dur", 0) for e in events
                          if e.get("cat") == "kernel"
                          and any(f in e.get("name", "") for f in frags))
        for label, frags in kernels.items()}


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
        gps_slide_profile(smi)
        return 0
    if "--cell" in sys.argv[1:]:
        seed = (int(sys.argv[sys.argv.index("--seed") + 1])
                if "--seed" in sys.argv[1:] else 7)
        cell_trace(smi, sys.argv[sys.argv.index("--cell") + 1], seed)
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
    flagship_iteration(smi)
    slide_profile(smi)
    return 0

if __name__ == "__main__":
    sys.exit(main())
