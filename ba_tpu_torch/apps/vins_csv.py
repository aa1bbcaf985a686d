"""End-to-end VINS pipeline on reference-format CSV sequences, on the port.

Port of `apps/vins_csv.py`.  Reads the five-file CSV format of the
reference's offline generator (points/accel/gyro/poses/timestamps,
`io/csvio.py`), triangulates landmarks from the observations (the format
carries no landmark positions), initializes velocities by central finite
differences of the positions, runs the visual-inertial GN solve
(`step.solve`, the banded grid: kernels 1, 2, segsum, K5b and K5 on the
card) from a perturbed start, and writes the optimized trajectory and the
ATE against the file's ground-truth poses.

    python -m ba_tpu_torch.apps.vins_csv seq --generate --poses 48 --lms 160
    python -m ba_tpu_torch.apps.vins_csv seq --perturb 0.02 --device cpu

Tensors live on `--device` (cuda unless told otherwise; without CUDA that
default raises).  f32 unless `--f64`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch


def _triangulate(sim):
    """Midpoint triangulation of each landmark from its first two
    observing poses (the CSV format stores observations only): the rays
    of all landmarks unprojected in one batch with the port's camera
    model, in f64.  Drops the observations of landmarks it cannot
    triangulate; returns how many it triangulated."""
    from ..core import camera as cam_mod
    from ..io.csvio import _quat_to_matrix

    firsts = {}                 # landmark -> {pose: first pixel}, in order
    for (i, j, z) in sim.obs:
        firsts.setdefault(j, {}).setdefault(i, np.asarray(z))
    pairs = [(j, list(f.items())[:2]) for j, f in firsts.items()
             if len(f) >= 2]
    n_lms = sim.lms_w.shape[0]
    lms_w = np.zeros((n_lms, 3))
    ok = np.zeros(n_lms, bool)
    if pairs:
        params = torch.zeros(cam_mod.MAX_PARAMS, dtype=torch.float64)
        params[: len(sim.cam_params)] = torch.as_tensor(sim.cam_params)
        pix = np.array([[z for _, z in obs] for _, obs in pairs])  # (n, 2, 2)
        rays = cam_mod.unproject(params, torch.tensor(cam_mod.MODEL_FOV),
                                 torch.as_tensor(pix)).numpy()
        R_vs = _quat_to_matrix(sim.tvs_q)
        for (j, obs), ray in zip(pairs, rays):
            o, d = [], []
            for (i, _), ray_s in zip(obs, ray):
                R_wv = _quat_to_matrix(sim.q_wv[i])
                o.append(sim.t_wv[i] + R_wv @ sim.tvs_t)
                d.append(R_wv @ R_vs @ ray_s)
            # midpoint of closest approach
            (o0, o1), (d0, d1) = o, d
            b = o1 - o0
            d00, d01, d11 = d0 @ d0, d0 @ d1, d1 @ d1
            den = d00 * d11 - d01 * d01
            if abs(den) < 1e-9:
                continue
            s = (d11 * (b @ d0) - d01 * (b @ d1)) / den
            t = (d01 * (b @ d0) - d00 * (b @ d1)) / den
            if s <= 0.05 or t <= 0.05:
                continue
            lms_w[j] = 0.5 * ((o0 + s * d0) + (o1 + t * d1))
            ok[j] = True
    sim.obs = [(i, j, z) for (i, j, z) in sim.obs if ok[j]]
    sim.lms_w = lms_w
    return int(ok.sum())


def read_sequence(seq_dir):
    """(SimData with velocities and triangulated landmarks, landmarks
    triangulated, ground-truth positions) of a sequence directory."""
    from ..io import csvio

    sim = csvio.read_csv(seq_dir)
    # the reference CSV format stores no velocities: central finite
    # differences of the pose positions
    sim.v_w = np.gradient(sim.t_wv, sim.pose_times, axis=0)
    n_tri = _triangulate(sim)
    return sim, n_tri, sim.t_wv.copy()


class Result(NamedTuple):
    problem: object     # the solved Problem
    summary: object     # step.Summary
    ate: float          # m, against the file's ground truth
    seconds: float      # wall seconds of the solve
    sim: object         # the SimData the problem was built from


def run(sim, gt_t, perturb=0.02, max_iter=25, device="cuda", f64=False):
    """Build the problem of `sim` (perturbed from seed 11, as the JAX
    app), solve it on `device` and measure its ATE against `gt_t`."""
    from ..core.problem import BAConfig
    from ..io import simulate_vins as sv
    from ..solver import step as step_mod
    from ..solver.assemble import band_width_of
    from ..utils.tree import tree_map

    cfg = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
    problem, _, _ = sv.build_problem(sim, cfg, perturb=perturb, seed=11,
                                     device=device)
    if not f64:
        problem = tree_map(lambda a: a.float()
                           if a.dtype == torch.float64 else a, problem)
    cfg = dataclasses.replace(cfg, band_width=band_width_of(problem))
    t0 = time.perf_counter()
    solved, summary = step_mod.solve(problem, cfg, max_iter=max_iter,
                                     use_imu=True)
    if solved.poses.t.is_cuda:
        torch.cuda.synchronize(solved.poses.t.device)
    secs = time.perf_counter() - t0
    P = len(sim.pose_times)
    ate = sv.ate(None, solved.poses.t[:P].double().cpu().numpy(), None,
                 gt_t)
    return Result(solved, summary, ate, secs, sim)


def write_trajectory(path, res: Result):
    """One line per pose: time, t (3), q (4, wxyz)."""
    P = len(res.sim.pose_times)
    t = res.problem.poses.t[:P].double().cpu().numpy()
    q = res.problem.poses.q[:P].double().cpu().numpy()
    with open(path, "w") as f:
        for i in range(P):
            f.write(",".join(f"{v:.9g}" for v in
                             [res.sim.pose_times[i], *t[i], *q[i]]) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seq_dir")
    ap.add_argument("--generate", action="store_true",
                    help="write a synthetic sequence to seq_dir first")
    ap.add_argument("--poses", type=int, default=48)
    ap.add_argument("--lms", type=int, default=160)
    ap.add_argument("--perturb", type=float, default=0.02)
    ap.add_argument("--max-iter", type=int, default=25)
    ap.add_argument("--out", default="trajectory_vins.csv")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..io import csvio
    from ..io import simulate_vins as sv

    if args.generate:
        sim = sv.simulate(n_poses=args.poses, n_lms=args.lms, seed=3)
        os.makedirs(args.seq_dir, exist_ok=True)
        csvio.write_csv(sim, args.seq_dir)
        print(f"wrote reference-format sequence to {args.seq_dir}")

    sim, n_tri, gt_t = read_sequence(args.seq_dir)
    print(f"read {len(sim.pose_times)} poses, {len(sim.obs)} observations, "
          f"{len(sim.imu_spans)} IMU spans; triangulated {n_tri} landmarks")
    res = run(sim, gt_t, args.perturb, args.max_iter, args.device, args.f64)
    s = res.summary
    print(f"solve on {res.problem.poses.t.device} "
          f"({res.problem.poses.t.dtype}): {s.result}, {s.iterations} iters, "
          f"cost {s.initial_cost:.4g} -> {s.final_cost:.4g}, "
          f"{res.seconds * 1e3:.1f} ms")
    print(f"ATE vs file ground truth: {res.ate * 100:.3f} cm")
    write_trajectory(args.out, res)
    print(f"wrote optimized trajectory to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
