#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port `ba_tpu_torch` on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero when a check fails:

  1. build the hand-written CUDA kernels from ba_tpu_torch/kernels/csrc/
     (one nvcc per source, started together) and print what ptxas reports;
  2. build the flagship problem of bench.py with the port alone:
     simulate(128 poses, 512 landmarks, seed 0), build_problem(perturb 0.01,
     seed 1), band width from the problem, cast to f32, prepare_landmarks;
  3. kernel 1 (reprojection) against its plain version, f64 and f32, with
     and without Jacobians, at the flagship rows and at a row count that is
     not a multiple of the kernel's 32-row blocks;
  4. kernel 2 (grouped segmented block sum) against its plain version on
     the seven sums of one flagship build, all in one launch over the
     build's segment plans, plus out-of-range ids and a segment of 2,100
     rows through one-group plans; two launches must give bit-identical
     output;
  5. the port on the card against the port on the CPU (whose plain path the
     CPU tests hold against ba_tpu) on a small f64 problem;
  6. GN `solve_fixed(..., 25)` and 7. the default dogleg `solve`, at the
     flagship size in f32: the cost and the ATE against the simulator's
     ground truth fall, everything is finite, and both kernels' launch
     counters moved by exactly the expected counts (kernel 2: one per
     build); host syncs per iteration, and those of the one-off plan;
  8. timings from CUDA events: each kernel per call (host launch cost
     included) and on the device (CUDA-graph replay), beside the launch
     floor (a one-element add, replayed the same way), its bound and its
     plain version; index_add_, kernel 2's library yardstick, both ways;
     the segment plans' one-off build; kf/s of both drivers.

The last lines are the `kernels` JSON line, the card's name and power
limit, and {"ok": true, "device": {...}}.  Without a CUDA device, or when
`ba_tpu_torch` is not next to this script, it exits non-zero before
printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N_POSES, N_LMS, N_ITERS = 128, 512, 25
# the sizes of bench.py's flagship problem
EXPECTED = dict(P=128, L=497, Nr=9696, Ni=127, B=24)

# Kernel tolerances, relative to max(1, max |plain|).  f64: the closed form
# and autodiff differ only in roundoff.  f32: two f32 evaluations through
# ~10^3 operations each.  Segment sums: the same values added in another
# order.
TOL_K1 = {"float64": 1e-10, "float32": 1e-4}
TOL_K2 = {"float64": 1e-12, "float32": 1e-5}
# card vs CPU on the small f64 problem: roundoff amplified by a few solves
# (the CPU tests hold the port to ba_tpu at the same 1e-8)
TOL_SMALL = 1e-8

# H100 SXM peaks at 700 W (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# floating-point operations of one reprojection row with Jacobians, counted
# from csrc/reprojection.cu (transfer chain ~185, projection ~70, the 13
# Jacobian columns ~800)
K1_FLOPS_PER_ROW = 1055


def check(cond, msg):
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        raise SystemExit(1)


def say(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want):
    """(max |got - want|, that over max(1, max |want|))."""
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.numel() == 0:
        return 0.0, 0.0
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(1.0, float(want.double().abs().max()))


def event_ms(fn, n):
    """Per-call time of `fn` over n back-to-back calls, CUDA events around
    the loop (host launch cost included, as the solve pays it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def graph_ms(fn, n, reps=5):
    """Device time per call of `fn`: n calls captured in one CUDA graph and
    replayed, so host launch cost drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * reps)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------


def phase_build():
    from ba_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build()
    for name, (secs, log) in report.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        say(f"build {name}.cu: {secs:.2f} s; ptxas: " + " | ".join(regs))
    say(f"PHASE build ok ({time.perf_counter() - t0:.2f} s)")


def flagship():
    """(f64 problem, f32 problem, config, SimData), both prepared."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver.assemble import band_width_of
    from ba_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    cfg = BAConfig(pose_dim=9, lm_size=1)
    sim = sv.simulate(n_poses=N_POSES, n_lms=N_LMS, seed=0)
    p64, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1)
    cfg = dataclasses.replace(cfg, band_width=band_width_of(p64))
    p32 = tree_map(lambda a: a.float() if a.dtype == torch.float64 else a,
                   p64)
    sizes = dict(P=p32.poses.q.shape[0], L=p32.lms.x.shape[0],
                 Nr=p32.proj.z.shape[0], Ni=int(p32.imu.valid.sum()),
                 B=cfg.band_width)
    say(f"flagship problem {sizes} on {p32.poses.q.device} "
        f"({time.perf_counter() - t0:.2f} s)")
    check(sizes == EXPECTED, f"flagship sizes {sizes} != {EXPECTED}")
    return (prepare_landmarks(p64, cfg), prepare_landmarks(p32, cfg), cfg,
            sim)


def cut_rows(p, n):
    """The problem with its first n projection rows."""
    proj = dataclasses.replace(p.proj, **{
        f.name: getattr(p.proj, f.name)[:n].contiguous()
        for f in dataclasses.fields(p.proj)})
    return dataclasses.replace(p, proj=proj)


def phase_k1(p64, p32, cfg):
    """Kernel 1 against the plain version, at the flagship rows and at a
    ragged last block; returns the f32 max abs error."""
    import torch

    from ba_tpu_torch.core.residuals import reprojection as rp

    worst = 0.0
    nr = p32.proj.z.shape[0] - 5
    check(nr % 32, "the ragged case must not fill its last block")
    for p in (p64, p32, cut_rows(p64, nr), cut_rows(p32, nr)):
        dt = str(p.proj.z.dtype).replace("torch.", "")
        for jac in (True, False):
            got = rp.evaluate(p, cfg, jac)
            want = rp.evaluate_plain(p, cfg, jac)
            torch.cuda.synchronize()
            for name in want._fields:
                err, rel = rel_err(getattr(got, name), getattr(want, name))
                check(rel <= TOL_K1[dt],
                      f"kernel 1 {dt} jac={jac} {name}: rel err {rel:.3g} "
                      f"> {TOL_K1[dt]:g}")
                if dt == "float32":
                    worst = max(worst, err)
                say(f"kernel 1 {dt} Nr={p.proj.z.shape[0]} jac={int(jac)} "
                    f"{name:7s} max abs err "
                    f"{err:.3e} rel {rel:.3e} (tol {TOL_K1[dt]:g})")
    say("PHASE kernel1 ok")
    return worst


def capture_build_sums(p, cfg):
    """The grouped segment sum of one build: [(name, vals (n, k), plan,
    ids, nseg)] in launch order, from the build's `AssemblyPlan`."""
    from ba_tpu_torch.solver import assemble as asm
    from ba_tpu_torch.solver import step

    plan = asm.assembly_plan(p, cfg)
    ids = asm.sum_ids(p, cfg)
    names = {id(sp): name for name, sp in plan._asdict().items()
             if name != "band_width"}
    calls = []
    orig = asm.seg_sum_groups

    def record(groups):
        calls.append([(v.reshape(v.shape[0], -1).clone(), sp)
                      for v, sp in groups])
        return orig(groups)

    asm.seg_sum_groups = record
    try:
        asm.assemble(p, cfg, imu_eval=step._imu_eval(p, cfg, True, True),
                     plan=plan)
    finally:
        asm.seg_sum_groups = orig
    check(len(calls) == 1 and len(calls[0]) == 7,
          f"a build made {len(calls)} grouped sums "
          f"({[len(c) for c in calls]} groups), not one of 7")
    return [(names[id(sp)], v, sp, *ids[names[id(sp)]])
            for v, sp in calls[0]]


def _k2_check(dt, what, got, again, vals, ids, nseg):
    """One sum of kernel 2 against `_seg_sum_plain` in f64 and against a
    second launch; returns the max abs error."""
    import torch

    from ba_tpu_torch.solver.assemble import _seg_sum_plain

    want = _seg_sum_plain(vals.double(), ids, nseg)
    err, rel = rel_err(got, want)
    same = bool(torch.equal(got, again))
    say(f"kernel 2 {dt} {what} n={vals.shape[0]} k={vals.shape[1]} "
        f"nseg={nseg}: max abs err {err:.3e} rel {rel:.3e} "
        f"(tol {TOL_K2[dt]:g}); bit-identical relaunch {same}")
    check(rel <= TOL_K2[dt], f"kernel 2 {what}: rel err {rel:.3g}")
    check(same, f"kernel 2 {what}: two launches differ")
    return err


def phase_k2(sums):
    """Kernel 2 against the plain version + determinism: the seven sums of
    a build in one grouped launch (f32 and f64), out-of-range ids and a
    2,100-row segment through one-group plans.  Returns the f32 max abs
    error."""
    import numpy as np
    import torch

    from ba_tpu_torch.kernels import segsum

    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        groups = [(v.to(dtype), sp) for _, v, sp, _, _ in sums]
        a = segsum.seg_sum_grouped(groups)
        b = segsum.seg_sum_grouped(groups)
        torch.cuda.synchronize()
        for (name, v, _, ids, nseg), x, y in zip(sums, a, b):
            err = _k2_check(dt, f"grouped launch, {name}", x, y, v, ids,
                            nseg)
            if dt == "float32":
                worst = max(worst, err)

    # out-of-range ids drop their rows (the flagship build has none)
    _, v, _, ids, nseg = sums[0]
    bad = ids.clone()
    bad[::5] = -1
    bad[1::7] = nseg + 3
    # one segment of ~2,140 rows: ~67 chunks, combined by the last to finish
    rng = np.random.default_rng(0)
    long_ids = rng.integers(0, 700, 30000)
    long_ids[rng.choice(30000, 2100, replace=False)] = 350
    long_ids = torch.as_tensor(long_ids, device=v.device)
    long_v = torch.as_tensor(rng.standard_normal((30000, 9)),
                             dtype=torch.float32, device=v.device)
    check(int((long_ids == 350).sum()) >= 2000, "long segment too short")
    for vals, ids_, nseg_, what in ((v, bad, nseg, "out-of-range ids"),
                                    (long_v, long_ids, 700,
                                     "2,100-row segment")):
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace("torch.", "")
            x = segsum.seg_sum(vals.to(dtype), ids_, nseg_)
            y = segsum.seg_sum(vals.to(dtype), ids_, nseg_)
            torch.cuda.synchronize()
            err = _k2_check(dt, what, x, y, vals, ids_, nseg_)
            if dt == "float32":
                worst = max(worst, err)
    say("PHASE kernel2 ok")
    return worst


def phase_small_reference():
    """The port on the card against the port on the CPU, f64, small."""
    import torch

    from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
    from ba_tpu_torch.io import simulate_vins as sv
    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import band_width_of

    sim = sv.simulate(n_poses=12, n_lms=48, seed=0)
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
        p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=1,
                                   device=dev)
        cfg = dataclasses.replace(cfg, band_width=band_width_of(p))
        pg, costs, dns = step.solve_fixed(prepare_landmarks(p, cfg), cfg,
                                          True, 5)
        pd, summ = step.solve(p, dataclasses.replace(cfg, use_dogleg=True),
                              max_iter=10)
        out[dev] = (pg, costs, dns, pd, summ)
    g, c = out["cuda"], out["cpu"]
    pairs = [("GN costs", g[1], c[1]), ("GN delta norms", g[2], c[2]),
             ("GN poses.t", g[0].poses.t, c[0].poses.t),
             ("GN lms.x", g[0].lms.x, c[0].lms.x),
             ("dogleg poses.t", g[3].poses.t, c[3].poses.t),
             ("dogleg lms.x_w", g[3].lms.x_w, c[3].lms.x_w),
             ("dogleg final cost", torch.tensor(g[4].final_cost),
              torch.tensor(c[4].final_cost))]
    for name, a, b in pairs:
        _, rel = rel_err(a.cpu(), b)
        say(f"card vs CPU, 12 poses f64: {name} rel err {rel:.3e} "
            f"(tol {TOL_SMALL:g})")
        check(rel <= TOL_SMALL, f"card vs CPU {name}: {rel:.3g}")
    same_path = (g[4].iterations, g[4].result, g[4].inner_iterations) == (
        c[4].iterations, c[4].result, c[4].inner_iterations)
    say(f"card vs CPU dogleg path: {g[4].iterations} iterations, "
        f"{g[4].result} (CPU {c[4].iterations}, {c[4].result})")
    check(same_path, "dogleg took another accept/reject path on the card")
    say("PHASE small-reference ok")


def _counters_zero():
    from ba_tpu_torch.kernels import reprojection, segsum
    from ba_tpu_torch.utils.sync import item

    reprojection.reprojection.launches = 0
    segsum.seg_sum_grouped.launches = 0
    item.count = 0


def _counters():
    from ba_tpu_torch.kernels import reprojection, segsum
    from ba_tpu_torch.utils.sync import item

    return (reprojection.reprojection.launches,
            segsum.seg_sum_grouped.launches, item.count)


def _sync_count(run):
    """Run `run()` with PyTorch's sync debug mode on; returns (result,
    number of synchronizing operations it reported)."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchronizing" in str(w.message) for w in caught)
    return out, n


def _ate(p, sim):
    from ba_tpu_torch.io import simulate_vins as sv

    return sv.ate(None, p.poses.t.double().cpu().numpy(), None, sim.t_wv)


def _finite(p):
    import torch

    return all(bool(torch.isfinite(t).all())
               for t in (p.poses.q, p.poses.t, p.poses.v, p.lms.x))


def plan_syncs(p32, cfg, smi):
    """Host syncs of building the segment plans of a solve (once per
    solve): the first build in the process, then a later one, which is
    what each solve of the drivers below pays."""
    import torch

    from ba_tpu_torch.solver.assemble import assembly_plan

    def run():
        out = assembly_plan(p32, cfg)
        torch.cuda.synchronize()
        return out

    first, again = _sync_count(run)[1], _sync_count(run)[1]
    say(f"[{smi}] segment plans of a solve: {first} host syncs at the "
        f"process's first build, {again} at a later one")
    return again


def phase_gn(p32, cfg, sim, smi, n_plan_syncs):
    import torch

    from ba_tpu_torch.solver import step
    from ba_tpu_torch.solver.assemble import evaluate_cost

    cfg = dataclasses.replace(cfg, use_dogleg=False)
    cost0 = float(evaluate_cost(p32, cfg, step._imu_eval(p32, cfg, True,
                                                         False)))
    ate0 = _ate(p32, sim)

    def run():
        out = step.solve_fixed(p32, cfg, True, N_ITERS)
        torch.cuda.synchronize()
        return out

    warm, syncs = _sync_count(run)                    # warm-up
    _counters_zero()
    t0 = time.perf_counter()
    p, costs, dns = run()
    secs = time.perf_counter() - t0
    k1, k2, reads = _counters()

    costs_h = costs.double().cpu()
    ate1 = _ate(p, sim)
    ok0 = bool(step._build_and_solve(p32, cfg, True).step.ok)
    ok1 = bool(step._build_and_solve(p, cfg, True).step.ok)
    say(f"GN solve_fixed({N_ITERS}) f32: cost {cost0:.6g} -> "
        f"{float(costs_h[-1]):.6g}, ATE {ate0:.6g} -> {ate1:.6g} m, "
        f"solver_ok at start/end {ok0}/{ok1}, kernel launches "
        f"reprojection {k1} segsum {k2}, bit-identical to the warm-up run "
        f"{torch.equal(costs, warm[1])}")
    check(bool(torch.isfinite(costs_h).all()) and _finite(p),
          "GN: non-finite values")
    check(float(costs_h[-1]) < cost0, "GN: cost did not fall")
    check(ate1 < ate0, "GN: ATE did not fall")
    check(ok0 and ok1, "GN: reduced factorization failed")
    check(k1 == 2 * N_ITERS, f"GN: {k1} reprojection launches, "
          f"expected {2 * N_ITERS} (one build + one trial per iteration)")
    check(k2 == N_ITERS, f"GN: {k2} segsum launches, expected "
          f"{N_ITERS} (one per build)")
    kf = N_POSES * N_ITERS / secs
    say(f"[{smi}] GN solve_fixed({N_ITERS}): {secs * 1e3:.1f} ms, "
        f"{kf:.1f} kf/s; host syncs {syncs}: the plan's {n_plan_syncs} "
        f"once, then {(syncs - n_plan_syncs) / N_ITERS:.2f} per iteration "
        f"(counted reads {reads})")
    say("PHASE gn ok")
    return dict(k1=k1, k2=k2, kf_s=kf, syncs=syncs, iters=N_ITERS)


def phase_dogleg(p32, cfg, sim, smi, n_plan_syncs):
    import torch

    from ba_tpu_torch.solver import step

    cfg = dataclasses.replace(cfg, use_dogleg=True)
    ate0 = _ate(p32, sim)

    def run():
        out = step.solve(p32, cfg, max_iter=N_ITERS)
        torch.cuda.synchronize()
        return out

    (_, warm), syncs = _sync_count(run)               # warm-up
    _counters_zero()
    t0 = time.perf_counter()
    p, s = run()
    secs = time.perf_counter() - t0
    k1, k2, reads = _counters()

    ate1 = _ate(p, sim)
    # host reads: one for use_imu, then per iteration one per inner trial
    # and one for the status; reprojection launches: one build per
    # iteration, one per trial, one for the error breakdown
    trials = reads - 1 - s.iterations
    say(f"dogleg solve f32: {s.iterations} iterations ({trials} trials), "
        f"{s.result}, cost {s.initial_cost:.6g} -> {s.final_cost:.6g}, "
        f"ATE {ate0:.6g} -> {ate1:.6g} m, kernel launches reprojection "
        f"{k1} segsum {k2}, same as the warm-up run "
        f"{(s.iterations, s.final_cost) == (warm.iterations, warm.final_cost)}")
    check(s.is_good, f"dogleg: result {s.result}")
    check(_finite(p) and torch.isfinite(torch.tensor(s.final_cost)),
          "dogleg: non-finite values")
    check(s.final_cost < s.initial_cost, "dogleg: cost did not fall")
    check(ate1 < ate0, "dogleg: ATE did not fall")
    check(k1 == s.iterations + trials + 1,
          f"dogleg: {k1} reprojection launches, expected "
          f"{s.iterations + trials + 1}")
    check(k2 == s.iterations, f"dogleg: {k2} segsum launches, "
          f"expected {s.iterations} (one per build)")
    kf = N_POSES * s.iterations / secs
    say(f"[{smi}] dogleg solve: {secs * 1e3:.1f} ms, {kf:.1f} kf/s; host "
        f"syncs {syncs}: the plan's {n_plan_syncs} once, then "
        f"{(syncs - n_plan_syncs) / s.iterations:.2f} per iteration "
        f"(counted reads {reads})")
    say("PHASE dogleg ok")
    return dict(k1=k1, k2=k2, kf_s=kf, syncs=syncs, iters=s.iterations)


def phase_timing(p32, cfg, sums, smi):
    """Per-kernel times at the main-path shapes, beside the launch floor,
    their bounds, their plain versions and the library yardstick."""
    import torch

    from ba_tpu_torch.core.residuals import reprojection as rp
    from ba_tpu_torch.kernels import reprojection as k1
    from ba_tpu_torch.kernels import segsum
    from ba_tpu_torch.solver.assemble import _seg_sum_plain, assembly_plan

    one = torch.zeros((1,), device=p32.poses.t.device)
    floor_ms = graph_ms(lambda: one.add_(1), 50)
    say(f"[{smi}] launch floor (a one-element add, CUDA-graph replay): "
        f"{floor_ms:.4f} ms")

    pr, poses, lms, rig = p32.proj, p32.poses, p32.lms, p32.rig
    outs = k1.reprojection(p32, True)
    k1_bytes = nbytes(pr.z, pr.pose, pr.lm, pr.cam, pr.valid, poses.q,
                      poses.t, lms.x, lms.ref_pose, lms.ref_cam, rig.params,
                      rig.model, rig.tvs_q, rig.tvs_t, *outs)
    rows = int(pr.valid.sum())
    k1_flops = K1_FLOPS_PER_ROW * rows
    k1_bound = max(k1_bytes / HBM_BPS, k1_flops / F32_FLOPS) * 1e3
    k1_by = "bytes" if k1_bytes / HBM_BPS >= k1_flops / F32_FLOPS \
        else "operations"
    t = dict(
        ms=event_ms(lambda: k1.reprojection(p32, True), 200),
        device_ms=graph_ms(lambda: k1.reprojection(p32, True), 50),
        resid_ms=event_ms(lambda: k1.reprojection(p32, False), 200),
        resid_device_ms=graph_ms(lambda: k1.reprojection(p32, False), 50),
        plain_ms=event_ms(lambda: rp.evaluate_plain(p32, cfg, True), 10))
    say(f"[{smi}] kernel 1 reprojection, Nr={pr.z.shape[0]} f32: "
        f"{t['ms']:.4f} ms per call ({t['device_ms']:.4f} ms on the device, "
        f"{t['device_ms'] / floor_ms:.2f}x the launch floor "
        f"{floor_ms:.4f} ms, {k1_bound / t['device_ms']:.1%} of the bound; "
        f"residual only {t['resid_ms']:.4f} ms, {t['resid_device_ms']:.4f} "
        f"ms on the device), plain {t['plain_ms']:.3f} ms, bound "
        f"{k1_bound:.5f} ms ({k1_by}: {k1_bytes} B, {k1_flops} flop)")
    rec1 = dict(ms=t["ms"], device_ms=t["device_ms"],
                resid_device_ms=t["resid_device_ms"], floor_ms=floor_ms,
                plain_ms=t["plain_ms"], bound_ms=k1_bound, bound_by=k1_by,
                library_ms=None)

    k2_bytes = k2_ops = 0
    for _, vals, _, ids, nseg in sums:
        k2_bytes += nbytes(vals, ids) + nseg * vals.shape[1] * \
            vals.element_size()
        k2_ops += int(((ids >= 0) & (ids < nseg)).sum()) * vals.shape[1]
    check(all(bool(((i >= 0) & (i < n)).all()) for *_, i, n in sums),
          "flagship segment ids out of range (index_add_ yardstick)")
    groups = [(v, sp) for _, v, sp, _, _ in sums]

    def seven(fn):
        return lambda: [fn(v, i, n) for _, v, _, i, n in sums]

    def library(v, i, n):
        return torch.zeros((n, v.shape[1]), dtype=v.dtype,
                           device=v.device).index_add_(0, i, v)

    k2_bound = max(k2_bytes / HBM_BPS, k2_ops / F32_FLOPS) * 1e3
    k2_by = "bytes" if k2_bytes / HBM_BPS >= k2_ops / F32_FLOPS \
        else "operations"
    t2 = dict(ms=event_ms(lambda: segsum.seg_sum_grouped(groups), 100),
              device_ms=graph_ms(lambda: segsum.seg_sum_grouped(groups), 20),
              plan_ms=event_ms(lambda: assembly_plan(p32, cfg), 10),
              plain_ms=event_ms(seven(_seg_sum_plain), 10),
              library_ms=event_ms(seven(library), 100),
              library_device_ms=graph_ms(seven(library), 20))
    shapes = ", ".join(f"{v.shape[0]}x{v.shape[1]}->{n}"
                       for _, v, _, _, n in sums)
    say(f"[{smi}] kernel 2 segsum, the seven sums of one build in one "
        f"launch ({shapes}) f32: {t2['ms']:.4f} ms per build "
        f"({t2['device_ms']:.4f} ms on the device, "
        f"{k2_bound / t2['device_ms']:.2%} of the bound); index_add_ "
        f"{t2['library_ms']:.4f} ms per build ({t2['library_device_ms']:.4f} "
        f"ms on the device); plain {t2['plain_ms']:.3f} ms; the plans' "
        f"one-off build {t2['plan_ms']:.4f} ms; bound {k2_bound:.5f} ms "
        f"({k2_by}: {k2_bytes} B, {k2_ops} adds); launch floor "
        f"{floor_ms:.4f} ms")
    rec2 = dict(ms=t2["ms"], device_ms=t2["device_ms"],
                plan_ms=t2["plan_ms"], plain_ms=t2["plain_ms"],
                bound_ms=k2_bound, bound_by=k2_by,
                library_ms=t2["library_ms"],
                library_device_ms=t2["library_device_ms"])
    say("PHASE timing ok")
    return rec1, rec2


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import ba_tpu_torch

    check(Path(ba_tpu_torch.__file__).resolve().parents[1] == ROOT,
          f"ba_tpu_torch imported from {ba_tpu_torch.__file__}, not from "
          f"this checkout")
    smi = smi_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    say(f"device {kind} x{count}; {smi}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    phase_build()
    p64, p32, cfg, sim = flagship()
    err1 = phase_k1(p64, p32, cfg)
    del p64
    sums = capture_build_sums(p32, cfg)
    err2 = phase_k2(sums)
    phase_small_reference()
    n_plan_syncs = plan_syncs(p32, cfg, smi)
    gn = phase_gn(p32, cfg, sim, smi, n_plan_syncs)
    dl = phase_dogleg(p32, cfg, sim, smi, n_plan_syncs)
    rec1, rec2 = phase_timing(p32, cfg, sums, smi)

    kernels = [
        dict(name="reprojection", route="cuda",
             source="ba_tpu_torch/kernels/csrc/reprojection.cu",
             replaces="80bbf6f^:ba_tpu/ops/reprojection_pallas.py:83",
             launches=gn["k1"] + dl["k1"], launches_gn=gn["k1"],
             launches_dogleg=dl["k1"], max_abs_err=err1, **rec1),
        dict(name="segsum", route="cuda",
             source="ba_tpu_torch/kernels/csrc/segsum.cu",
             replaces="ba_tpu/solver/assemble.py:120",
             launches=gn["k2"] + dl["k2"], launches_gn=gn["k2"],
             launches_dogleg=dl["k2"], max_abs_err=err2, **rec2),
    ]
    say(f"[{smi}] kf/s: GN solve_fixed({N_ITERS}) {gn['kf_s']:.1f}, "
        f"dogleg solve {dl['kf_s']:.1f} ({dl['iters']} iterations); "
        f"total smoke {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
