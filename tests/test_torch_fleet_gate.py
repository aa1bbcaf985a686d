"""The fused fleet's choice of solver, in the port alone (f64, CPU).

A fused fleet of F windows takes the per-window dense solve only when
every valid row stays inside one of F equal windows (P/F poses, L/F
landmarks); the banded solver splits into F windows only when the rows stay
inside equal pose windows.  `solve_plan` reads that once per solve.  On the
four unequal fleets measured in ROADMAP.md (queue 3, deliberate
differences) the fused fleet with `fleet_size` 2 takes the banded path and
one GN iteration equals the `fleet_size` 1 iteration to 1e-9 (ba_tpu takes
the dense solve on the first two and drops the rows that cross the split);
equal windows keep the dense fleet solve.
"""

import dataclasses
import functools

import pytest
import torch

from ba_tpu_torch.core.problem import (BAConfig, concat_problems,
                                       prepare_landmarks)
from ba_tpu_torch.io import simulate_vins as sv
from ba_tpu_torch.solver import step
from ba_tpu_torch.solver.assemble import band_width_of
from ba_tpu_torch.utils.sync import item

from test_torch_common import assert_rel

CFG = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)

# (poses, simulated landmarks, perturbation seed) per window; the builder
# keeps 23, 24 and 25 of 30, 31 and 32 simulated landmarks at <= 16 poses
# (24 and 25 of 30 and 31 at 20)
FLEETS = {
    "12+12;23+25": ((12, 30, 1), (12, 32, 2)),
    "16+20;23+25": ((16, 30, 1), (20, 31, 2)),
    "10+14;23+24": ((10, 30, 1), (14, 31, 2)),
    "16+20;23+24": ((16, 30, 1), (20, 30, 2)),
    "12+12;23+23": ((12, 30, 1), (12, 30, 2)),
}


@functools.lru_cache(maxsize=None)
def fused(kind):
    windows = []
    for n_poses, n_lms, seed in FLEETS[kind]:
        sim = sv.simulate(n_poses=n_poses, n_lms=n_lms, seed=0)
        windows.append(sv.build_problem(sim, CFG, perturb=0.01, seed=seed,
                                        device="cpu")[0])
    p = concat_problems(windows, CFG)
    cfg = dataclasses.replace(CFG, band_width=band_width_of(p),
                              use_banded_solver=True, fleet_size=2)
    return prepare_landmarks(p, cfg), cfg


@pytest.mark.parametrize("kind", list(FLEETS)[:4])
def test_unequal_fleet_takes_banded_and_matches_fleet_size_1(kind):
    p, cfg = fused(kind)
    sizes = [w[0] for w in FLEETS[kind]]
    assert p.poses.q.shape[0] == sum(sizes)
    assert step._reduced_path(p, cfg)[0] == "banded"
    item.count = 0
    plan = step.solve_plan(p, cfg)
    assert item.count == 1                  # one read per solve
    # split in two only where the pose windows are equal
    assert plan.fleet is None
    assert plan.windows == (2 if sizes[0] == sizes[1] else 1)
    got = step.gn_iteration(p, cfg, True, plan=plan)
    assert item.count == 1                  # none per iteration
    want = step.gn_iteration(p, dataclasses.replace(cfg, fleet_size=1), True)
    for name in ("pre_cost", "post_cost", "delta_norm", "accepted",
                 "solver_ok"):
        assert_rel(getattr(got, name), getattr(want, name), 1e-9, name)
    for name in ("q", "t", "v"):
        assert_rel(getattr(got.problem.poses, name),
                   getattr(want.problem.poses, name), 1e-9, name)
    assert_rel(got.problem.lms.x, want.problem.lms.x, 1e-9, "lms.x")
    assert float(got.post_cost) < float(got.pre_cost)


def test_equal_fleet_keeps_the_dense_fleet_solve():
    p, cfg = fused("12+12;23+23")
    assert step._reduced_path(p, cfg)[0] == "fleet_dense"
    plan = step.solve_plan(p, cfg)
    assert plan.fleet is not None and plan.windows == 2
    res = step.gn_iteration(p, cfg, True, plan=plan)
    assert bool(res.solver_ok) and float(res.post_cost) < float(res.pre_cost)
    assert bool(torch.isfinite(res.problem.poses.t).all())
