"""Online streaming VINS on the port: one keyframe in, one estimate out.

Port of `apps/vins_stream.py`: keyframes and their measurements arrive
one at a time through `StreamingRing.add_*`; each `push(block=False)`
solves the compact W-keyframe window and retires the oldest keyframe.
Reports the first push, the steady-state keyframes retired per second and
the retired-trajectory ATE against ground truth.  With `--streams M`, M
independent streams of the same sequence (build seeds 8 .. 8 + M - 1) are
pushed round-robin, one ring each (`stream_many`), and the aggregate and
per-stream rates and each stream's ATE are reported.

    python -m ba_tpu_torch.apps.vins_stream --poses 64 --window 8
    python -m ba_tpu_torch.apps.vins_stream --poses 128 --lms 2048 \\
        --window 10          # a VIO window at VINS-Mono's EuRoC density
    python -m ba_tpu_torch.apps.vins_stream --poses 128 --lms 2048 \\
        --window 10 --streams 4   # four vehicles' streams, round-robin

Tensors live on `--device` (cuda unless told otherwise; without CUDA that
default raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch


def stream_feed(problem):
    """The measurements of a built problem as numpy arrays, for feeding it
    keyframe by keyframe (`add_keyframe`)."""
    po, lm, pr, imu = problem.poses, problem.lms, problem.proj, problem.imu

    def host(node, names):
        return {f: getattr(node, f).detach().cpu().numpy() for f in names}

    return dict(po=host(po, ("q", "t", "v", "b", "time", "mask")),
                lm=host(lm, ("x_w", "ref_cam", "z_ref", "has_z_ref",
                             "ref_pose", "active")),
                pr=host(pr, ("z", "cam", "weight", "cond", "valid", "pose",
                             "lm")),
                imu=host(imu, ("w", "a", "time", "meas_valid", "valid",
                               "pose1", "cond")))


def add_keyframe(ring, feed, g: int) -> None:
    """Buffer keyframe g of `feed`: its pose, the landmarks anchored at
    it, its observations and the IMU span from keyframe g-1."""
    po, lm, pr, imu = feed["po"], feed["lm"], feed["pr"], feed["imu"]
    ring.add_pose(po["q"][g], po["t"][g], po["v"][g], po["b"][g],
                  float(po["time"][g]), po["mask"][g])
    for lid in np.where(lm["active"] & (lm["ref_pose"] == g))[0]:
        z_ref = lm["z_ref"][lid] if bool(lm["has_z_ref"][lid]) else None
        ring.add_landmark(lm["x_w"][lid], g, int(lm["ref_cam"][lid]),
                          z_ref=z_ref)
    for r in np.where(pr["valid"] & (pr["pose"] == g))[0]:
        ring.add_projection(pr["z"][r], g, int(pr["lm"][r]),
                            int(pr["cam"][r]), float(pr["weight"][r]),
                            bool(pr["cond"][r]))
    if g >= 1:
        for r in np.where(imu["valid"] & (imu["pose1"] == g - 1))[0]:
            n = int(imu["meas_valid"][r].sum())
            ring.add_imu(g - 1, g, imu["w"][r][:n], imu["a"][r][:n],
                         imu["time"][r][:n], cond=bool(imu["cond"][r]))


def wait(device) -> None:
    """Wait until the device has finished the queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_sequence(problem, cfg, W, iters, caps):
    """Drive a built problem's data through a StreamingRing keyframe by
    keyframe, on the problem's device and float type: `stream_many` of one
    stream.  Returns (outs as numpy, steady seconds, steady keyframes).
    The steady-state timer starts once the first push has drained, so that
    its one-off costs (kernel builds among them) stay out of the rate."""
    outs, t_steady, n_steady = stream_many([problem], cfg, W, iters, caps)
    return outs[0], t_steady, n_steady


def stream_many(problems, cfg, W, iters, caps, warm_drop=1,
                keyframes=None):
    """Round-robin M independent streams, one StreamingRing each, on the
    problems' device and float type: the multi-stream serving shape.  Each
    keyframe index is fed and pushed on every stream in turn before the
    next, up to `keyframes` (all of them by default).  The steady-state
    timer starts once the last stream's first `warm_drop` pushes have
    drained.  Returns (per-stream outs as numpy, steady seconds, keyframes
    retired after the warm-up)."""
    from ..solver.streaming import StreamingRing

    if warm_drop < 1:
        raise ValueError(f"warm_drop {warm_drop}: the timer starts after at "
                         "least one drained push")
    dev = problems[0].poses.t.device
    feeds = [stream_feed(pb) for pb in problems]
    rings = [StreamingRing(cfg, W, pb.rig, pb.g_vec, caps, use_imu=True,
                           iters_per_slide=iters,
                           dtype=f["po"]["t"].dtype, device=dev)
             for pb, f in zip(problems, feeds)]
    M = len(problems)
    outs = [[] for _ in range(M)]
    n_steady = 0
    t0 = time.perf_counter()
    if keyframes is None:
        keyframes = int(problems[0].poses.q.shape[0])
    for g in range(keyframes):
        for m in range(M):
            add_keyframe(rings[m], feeds[m], g)
            out = rings[m].push(block=False)
            if out is None:
                continue
            outs[m].append(out)
            if m == M - 1 and len(outs[m]) == warm_drop:
                wait(dev)
                t0 = time.perf_counter()
            if len(outs[m]) > warm_drop:
                n_steady += 1
    wait(dev)
    t_steady = time.perf_counter() - t0
    return ([[{k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
               for k, v in o.items()} for o in os_] for os_ in outs],
            t_steady, n_steady)


def stream_problem(poses, lms, perturb=0.02, f64=False, device="cuda",
                   seed=8):
    """(prepared problem, config, SimData) of `apps/vins_stream.py`:
    simulate(poses, lms, seed 7), build_problem(perturb, `seed` (8; stream
    m of a multi-stream run takes 8 + m), no marg prior), pose_dim 9,
    inverse depth, GN; f32 unless `f64`."""
    from ..core.problem import BAConfig, prepare_landmarks
    from ..io import simulate_vins as sv
    from ..utils.tree import tree_map

    sim = sv.simulate(n_poses=poses, n_lms=lms, seed=7)
    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    problem, _, _ = sv.build_problem(sim, cfg, perturb=perturb, seed=seed,
                                     with_marg_prior=False, device=device)
    if not f64:
        problem = tree_map(lambda a: a.float()
                           if a.dtype == torch.float64 else a, problem)
    return prepare_landmarks(problem, cfg), cfg, sim


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=64)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--lms", type=int, default=256)
    ap.add_argument("--perturb", type=float, default=0.02)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--streams", type=int, default=1,
                    help="interleave M independent streams (multi-vehicle "
                         "serving), each with its own ring")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..io import simulate_vins as sv
    from ..solver import fixedlag
    from ..solver.streaming import RingCapacities

    problem, cfg, sim = stream_problem(args.poses, args.lms, args.perturb,
                                       args.f64, args.device)
    # size the ring's capacities from the sequence (in a deployment they
    # come from the feature and IMU budget)
    n_slides = args.poses - args.window + 1
    sched = fixedlag.build_ring_schedule(problem, cfg, args.window,
                                         n_slides)
    caps = RingCapacities.from_schedule(sched)
    if args.streams > 1:
        problems = [problem] + [
            stream_problem(args.poses, args.lms, args.perturb, args.f64,
                           args.device, seed=8 + m)[0]
            for m in range(1, args.streams)]
        outs, t_steady, n_steady = stream_many(problems, cfg, args.window,
                                               args.iters, caps)
        ates = [sv.ate(None, np.stack([x["t"] for x in o]), None,
                       sim.t_wv[:len(o)]) for o in outs]
        rate = n_steady / max(t_steady, 1e-9)
        rounds = n_steady / args.streams
        print(f"{args.streams} streams x {args.poses} keyframes on "
              f"{problem.poses.t.device}: steady-state {rate:.3f} "
              f"keyframes/s aggregate ({rate / args.streams:.3f} per "
              f"stream), {1e3 * t_steady / max(rounds, 1e-9):.1f} ms per "
              f"round of {args.streams} slides "
              f"({1e3 * t_steady / max(n_steady, 1):.1f} ms per slide); "
              f"retired {[len(o) for o in outs]}; ATE "
              f"{min(ates) * 100:.3f}..{max(ates) * 100:.3f} cm (per stream "
              + ", ".join(f"{a * 100:.3f}" for a in ates) + ")")
        return 0
    t0 = time.perf_counter()
    outs, t_steady, n_steady = stream_sequence(problem, cfg, args.window,
                                               args.iters, caps)
    total = time.perf_counter() - t0
    n = len(outs)
    ate = sv.ate(None, np.stack([o["t"] for o in outs]), None,
                 sim.t_wv[:n])
    print(f"streamed {args.poses} keyframes on {problem.poses.t.device}, "
          f"retired {n}; first push {total - t_steady:.2f}s; steady-state "
          f"{n_steady / max(t_steady, 1e-9):.1f} keyframes/s; "
          f"retired-trajectory ATE {ate * 100:.3f} cm; "
          f"last cost {float(outs[-1]['cost']):.4g}; "
          f"caps {dataclasses.asdict(caps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
