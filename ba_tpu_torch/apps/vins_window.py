"""Sliding-window VINS on the port: fixed-lag smoothing with
marginalization.

Port of `apps/vins_window.py`.  Keyframes of a `simulate_vins` sequence go
through a fixed-size window.  By default each step solves the window on
the banded path (`step.solve`) and marginalizes the oldest pose into the
dense prior; `--ring` runs the ring-buffer compact window of
`solver/fixedlag` instead (general path, O(window) per slide) and prints
the retired-keyframe trajectory's ATE.

    python -m ba_tpu_torch.apps.vins_window --poses 40 --window 10
    python -m ba_tpu_torch.apps.vins_window --poses 40 --window 10 --ring

Tensors live on `--device` (cuda unless told otherwise; without CUDA that
default raises).  f32 unless `--f64`.  The run ends with the program's
spans (`utils.timing.report`: the solves, their iterations, builds,
reduced solves, trials, marginalizations and host reads), recorded under
`timing.enable()`.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=24)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--lms", type=int, default=120)
    ap.add_argument("--perturb", type=float, default=0.02)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--ring", action="store_true",
                    help="ring-buffer compact window (solver/fixedlag): "
                         "O(window) per slide; prints the retired-keyframe "
                         "trajectory ATE")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..core.problem import BAConfig, prepare_landmarks
    from ..io import simulate_vins as sv
    from ..solver import step as step_mod
    from ..solver import window as window_mod
    from ..solver.assemble import band_width_of
    from ..utils import timing
    from ..utils.tree import tree_map

    sim = sv.simulate(n_poses=args.poses, n_lms=args.lms, seed=7)
    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False,
                   error_change_threshold=1e-4, param_change_threshold=1e-6)
    problem, _, _ = sv.build_problem(sim, cfg, perturb=args.perturb, seed=8,
                                     device=args.device)
    if not args.f64:
        problem = tree_map(lambda a: a.float()
                           if a.dtype == torch.float64 else a, problem)
    dev = problem.poses.t.device
    # banded-grid assembly (host-side, the structure is static)
    cfg = dataclasses.replace(cfg, band_width=band_width_of(problem))
    P = problem.poses.q.shape[0]

    if args.ring:
        from ..solver import fixedlag

        cfg_r = dataclasses.replace(cfg, band_width=0)   # compact: general
        pr = prepare_landmarks(problem, cfg_r)
        sched = fixedlag.build_ring_schedule(pr, cfg_r, args.window)
        _, outs = fixedlag.run_ring(sched, cfg_r, True, 2)     # first run
        timing.wait(outs)
        t0 = time.perf_counter()
        with timing.enable():
            _, outs = fixedlag.run_ring(sched, cfg_r, True, 2)
            timing.wait(outs)
        dt = time.perf_counter() - t0
        n = sched.n_slides
        ate = sv.ate(None, outs["t"].double().cpu().numpy(), None,
                     sim.t_wv[:n])
        print(f"ring on {dev}: {n} keyframes retired in {dt * 1e3:.1f} ms "
              f"({n / dt:.1f}/s, second run); retired-trajectory ATE "
              f"{ate * 100:.3f} cm; last window cost "
              f"{float(outs['cost'][-1]):.4g}")
        print(timing.report())
        return 0

    p = problem
    n_marg = args.poses - args.window
    summ = None
    with timing.enable():
        for k in range(2, 2 + n_marg):
            p, summ = step_mod.solve(p, cfg, max_iter=6, use_imu=True)
            p = window_mod.apply_marginalization(
                p, cfg, True, torch.arange(P, device=dev) == k)
            n_active = int(p.poses.active.sum())
            print(f"step {k - 1:3d}: cost {summ.final_cost:10.4g}  "
                  f"active poses {n_active}")
        p, summ = step_mod.solve(p, cfg, max_iter=10, use_imu=True)

    sl = slice(2 + n_marg, args.poses)
    ate = sv.ate(None, p.poses.t[sl].double().cpu().numpy(), None,
                 sim.t_wv[sl])
    print(f"final window cost {summ.final_cost:.4g}; ATE over window "
          f"poses: {ate * 100:.3f} cm; on {dev} ({n_marg} steps)")
    print(timing.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
