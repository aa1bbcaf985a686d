"""Fleet serving on the port: many vehicles' sliding windows as one solve.

Port of `apps/fleet_serve.py`'s fused route.  B vehicles' windows of one
simulated scene (same geometry, perturbed with seeds 100 + v) are fused
into one block-diagonal problem (`concat_problems`) and solved by GN on the
banded solver with `fleet_size = B`: per-window dense Schur complements
(kernel 10) and one batched Cholesky when the windows are small enough
(`solver/banded.py:solve_reduced_fleet_dense`), else the banded factor with
a fleet axis.

    python -m ba_tpu_torch.apps.fleet_serve --vehicles 4 --poses 64 --iters 10

Tensors live on `--device` (cuda unless told otherwise; without CUDA that
default raises), in f32.  `--mesh N` (windows sharded over N devices) is
not ported yet and raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vehicles", type=int, default=4)
    ap.add_argument("--poses", type=int, default=64)
    ap.add_argument("--lms", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard whole windows over an N-device mesh (not "
                         "ported yet)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "the sharded fleet (--mesh) is not ported yet (ROADMAP.md queue 1 "
            "item 4)")

    from ..core.problem import BAConfig, concat_problems, prepare_landmarks
    from ..io import simulate_vins as sv
    from ..solver import step as step_mod
    from ..solver.assemble import band_width_of
    from ..utils.tree import tree_map
    from .vins_stream import wait

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    sim = sv.simulate(n_poses=args.poses, n_lms=args.lms, seed=0)
    windows = []
    for v in range(args.vehicles):
        p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=100 + v,
                                   device=args.device)
        windows.append(tree_map(lambda a: a.float()
                                if a.dtype == torch.float64 else a, p))
    fused = concat_problems(windows, cfg)
    dev = fused.poses.t.device
    cfg = dataclasses.replace(cfg, band_width=band_width_of(fused),
                              use_banded_solver=True,
                              fleet_size=args.vehicles)
    fused = prepare_landmarks(fused, cfg)
    path = step_mod._reduced_path(fused, cfg)[0]

    for run in ("first", "second"):
        t0 = time.perf_counter()
        out, costs, _ = step_mod.solve_fixed(fused, cfg, True, args.iters)
        wait(dev)
        dt = time.perf_counter() - t0
    P_w = args.poses
    ates = [sv.ate(None, out.poses.t[v * P_w:(v + 1) * P_w].double().cpu()
                   .numpy(), None, sim.t_wv[:P_w])
            for v in range(args.vehicles)]
    kf_s = args.vehicles * args.poses * args.iters / dt
    print(f"fleet of {args.vehicles} x {args.poses}-kf windows fused on "
          f"{dev} ({path}): {dt * 1e3:.1f} ms for {args.iters} GN iterations "
          f"(second run), {kf_s:.0f} keyframes/s; fused cost "
          f"{float(costs[0]):.4g} -> {float(costs[-1]):.4g}; per-window ATE "
          f"{min(ates) * 100:.3f}..{max(ates) * 100:.3f} cm")
    return 0


if __name__ == "__main__":
    sys.exit(main())
