"""Fleet serving on the port: many vehicles' sliding windows as one solve.

Port of `apps/fleet_serve.py`.  B vehicles' windows of one simulated scene
(same geometry, perturbed with seeds 100 + v) are solved by GN:

  * fused (the default): one block-diagonal problem (`concat_problems`)
    on the banded solver with `fleet_size = B`: per-window dense Schur
    complements (kernel 10) and one batched Cholesky when the windows are
    small enough (`solver/banded.py:solve_reduced_fleet_dense`), else the
    banded factor with a fleet axis;
  * `--mesh N`: the windows stacked (`stack_problems`) and sharded over N
    ranks, whole windows each (`parallel/shard.py:sharded_fleet_solve`,
    no collective in the solve).  The launcher builds the kernels once,
    then spawns the ranks (`parallel/mesh.py:spawn`).  The backend rule:
    with a card per rank, rank r takes `cuda:r` over NCCL; ranks that
    share one card all take `cuda:0` over gloo, as do ranks on the CPU.
    The join and every collective time out after 120 s
    (`mesh.TIMEOUT_S`), and the launcher waits for the whole run at most
    600 s (`mesh.SPAWN_TIMEOUT_S`): then, or when a rank fails, every
    rank is killed and the app fails.  Rank 0 prints the line and, with
    `--out FILE`, saves every window's GN costs and final poses
    (`torch.save`: costs (B, iters), q (B, P, 4), t (B, P, 3)).

    python -m ba_tpu_torch.apps.fleet_serve --vehicles 4 --poses 64 --iters 10
    python -m ba_tpu_torch.apps.fleet_serve --vehicles 128 --trace trace_dir
    python -m ba_tpu_torch.apps.fleet_serve --vehicles 8 --mesh 2 \
        --out fleet.pt

With `--trace DIR` (fused), one more solve runs under `torch.profiler`:
its Chrome trace (`DIR/trace.json`, the program's spans over the card's
kernels), the program's spans (`utils.timing.report`) and the card's idle
seconds by the span open on the host when each idle gap began
(`utils.timing.attribute`) are the way to see where a tick's time goes.

Tensors live on `--device` (cuda unless told otherwise; without CUDA that
default raises), in f32.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch


def _windows(args, cfg, device):
    """(SimData, the B vehicles' windows in f32 on `device`)."""
    from ..io import simulate_vins as sv
    from ..utils.tree import tree_map

    sim = sv.simulate(n_poses=args.poses, n_lms=args.lms, seed=0)
    windows = []
    for v in range(args.vehicles):
        p, _, _ = sv.build_problem(sim, cfg, perturb=0.01, seed=100 + v,
                                   device=device)
        windows.append(tree_map(lambda a: a.float()
                                if a.dtype == torch.float64 else a, p))
    return sim, windows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vehicles", type=int, default=4)
    ap.add_argument("--poses", type=int, default=64)
    ap.add_argument("--lms", type=int, default=256)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard whole windows over N ranks (0: fused on "
                         "one device)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="",
                    help="with --mesh: save the windows' costs and poses")
    ap.add_argument("--trace", default="",
                    help="fused: profile one more solve, write its Chrome "
                         "trace to this directory and print the program's "
                         "spans and the idle time by span")
    args = ap.parse_args(argv)
    if args.mesh:
        if args.vehicles % args.mesh:
            ap.error("--vehicles must be a multiple of --mesh")
        if args.trace:
            ap.error("--trace profiles the fused solve, not --mesh")
        return _serve_mesh(args)

    from ..core.problem import BAConfig, concat_problems, prepare_landmarks
    from ..io import simulate_vins as sv
    from ..solver import step as step_mod
    from ..solver.assemble import band_width_of
    from .vins_stream import wait

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    sim, windows = _windows(args, cfg, args.device)
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
    if args.trace:
        from ..utils import timing

        timing.reset()
        with timing.trace_to(args.trace) as prof:
            step_mod.solve_fixed(fused, cfg, True, args.iters)
            wait(dev)
        print(timing.report())
        print("device idle by program span (s): " + ", ".join(
            f"{k} {v:.6f}" for k, v in timing.attribute(prof).items()))
    return 0


def _serve_mesh(args) -> int:
    """Spawn the ranks of `--mesh` and wait for them (`mesh.spawn`: a
    rank's failure or the timeout raises)."""
    from .. import resolve_device
    from ..parallel.mesh import spawn

    if resolve_device(args.device).type == "cuda":
        from ..kernels import build

        build.build()                 # once, before the ranks start
    spawn(_rank, args.mesh, (args,))
    return 0


def _rank(rank: int, size: int, init_method: str, args) -> None:
    """One rank of `--mesh`: its windows of the stacked fleet, solved
    twice (the second run timed); rank 0 prints the fleet's line."""
    from ..core.problem import BAConfig, prepare_landmarks, stack_problems
    from ..io import simulate_vins as sv
    from ..parallel import shard
    from ..parallel.mesh import Mesh, rank_device
    from .vins_stream import wait

    dev = rank_device(args.device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // size))
    mesh = Mesh.init(rank, size, dev, init_method)
    try:
        cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
        sim, windows = _windows(args, cfg, dev)
        fleet = stack_problems([prepare_landmarks(p, cfg) for p in windows])
        for run in ("first", "second"):
            mesh.barrier()                  # the ranks start together
            t0 = time.perf_counter()
            out, costs, _ = shard.sharded_fleet_solve(fleet, cfg, True, mesh,
                                                      args.iters)
            wait(dev)
            dt = time.perf_counter() - t0
        ates = [sv.ate(None, t.double().cpu().numpy(), None,
                       sim.t_wv[:args.poses]) for t in out.poses.t]
        mine = torch.tensor([[float(costs[w, -1]), a, dt]
                             for w, a in enumerate(ates)],
                            dtype=torch.float64, device=dev)
        rows = mesh.gather_rows(mine).cpu()
        if args.out:
            saved = {k: mesh.gather_rows(v.contiguous()).cpu()
                     for k, v in (("costs", costs), ("q", out.poses.q),
                                  ("t", out.poses.t))}
            if rank == 0:
                torch.save(saved, args.out)
        if rank == 0:
            dt = float(rows[:, 2].max())          # the slowest rank's time
            kf_s = args.vehicles * args.poses * args.iters / dt
            print(f"fleet of {args.vehicles} x {args.poses}-kf windows "
                  f"(sharded over {size} ranks, {mesh.backend} on "
                  f"{dev.type}): {dt * 1e3:.1f} ms steady-state, "
                  f"{kf_s:.0f} keyframes/s; final cost(s) "
                  f"{float(rows[:, 0].min()):.3e}.."
                  f"{float(rows[:, 0].max()):.3e}; per-window ATE "
                  f"{float(rows[:, 1].min()) * 100:.3f}.."
                  f"{float(rows[:, 1].max()) * 100:.3f} cm", flush=True)
    finally:
        mesh.close()


if __name__ == "__main__":
    sys.exit(main())
