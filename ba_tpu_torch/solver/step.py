"""Step control: update application, Gauss-Newton, and Powell dogleg.

Port of `ba_tpu/solver/step.py`.  A step proposal never mutates the
problem: it produces a candidate tree, and rollback is not committing it
(`tree_where`).  Python loops take the place of `lax.scan`/`while_loop`/
`cond`; the data-dependent exits (a dogleg trial accepted, the adaptive
solve's exit test) read from the device once each, counted by
`utils.sync.item`.  GN iterations need no host read.

The dogleg boundary blend uses the textbook root
beta = (-b + sqrt(b^2 - 4 a c)) / (2 a), as the JAX package does.

Ported reduced solves (`_reduced_path` picks one from static properties,
as ba_tpu's `_build_and_solve` does):

  * dense Cholesky on either assembly path, the banded grid or the general
    one (`assemble.plan_width` picks it from `config.band_width`);
  * `use_banded_solver`: the block system (`solver/cg.py`), the banded
    Schur band and the chunked factorization as the preconditioner of a
    short PCG (`banded.solve_reduced_banded`);
  * `use_banded_solver` on a fused fleet (`fleet_size` F > 1): the
    per-window dense Schur complement and one batched Cholesky
    (`banded.solve_reduced_fleet_dense`) when F divides the pose and
    landmark counts, a window's system has at most 4,096 rows and every
    valid row's ids lie inside one equal window (`solve_plan` reads this
    once per solve), else the banded solver, with a fleet axis when the
    rows stay inside equal pose windows;
  * `schur_on_band`: the banded Schur band, densified with the
    marginalization prior and solved by one Cholesky
    (`banded.solve_reduced_banded_dense`);
  * `use_cg_solver`: matrix-free block-Jacobi PCG on the block system
    (`cg.solve_reduced_cg`).

`use_banded_solver` without a band, or with a marginalization prior, falls
back to the next path as in ba_tpu.  A solve builds the segment plans of
its builds once, before the loop (`solve_plan`: an `AssemblyPlan` or a
`cg.BlockPlan`), and hands them to every iteration.

Self-calibration (a calibration block, K > 0) runs on the general dense
path: `apply_update` moves the intrinsics and T_vs of camera 0 and
re-unprojects the inverse-depth rays; `solve_adaptive`, the one loop of
`solve`, prints each iteration with `verbose` and holds the T_vs
translation while `staging` waits for the extrinsic to settle; the
calibration epilogue gives the calibration marginals and dumps the
reduced system.  A deliberate difference from ba_tpu: a fused fleet whose
windows are not equal takes the banded path, where ba_tpu drops rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..core import camera as cam_mod
from ..core import lie
from ..core.problem import (BAConfig, Problem, finalize_landmarks,
                            prepare_landmarks)
from ..core.residuals import imu as imu_mod
from ..utils import timing
from ..utils.sync import item, values
from ..utils.tree import tree_where
from . import banded as banded_mod
from . import cg as cg_mod
from .assemble import (Assembly, assemble, assembly_plan, band_width_of,
                       dims, evaluate_cost)
from .linear import (GnStep, calibration_marginals, dump_system,
                     solve_reduced)


def _imu_eval(problem: Problem, config: BAConfig, use_imu: bool,
              with_jacobians: bool, c9=None):
    if not use_imu:
        return None
    with timing.span("imu"):
        return imu_mod.evaluate(problem, config,
                                with_jacobians=with_jacobians, c9=c9)


def apply_update(problem: Problem, config: BAConfig, delta_p, delta_l,
                 scale=1.0) -> Problem:
    """x <- retract(x, -scale * delta).  Inverse-depth landmarks whose depth
    would go negative keep their old value and are marked unreliable.  A
    calibration block moves camera 0's intrinsics and T_vs; when the
    intrinsics move, each inverse-depth ray is unprojected again from its
    reference pixel, keeping its norm."""
    with timing.span("update"):
        D = config.pose_dim
        poses = problem.poses
        P = poses.q.shape[0]
        dp = delta_p[: P * D].reshape(P, D) * scale

        q, t = lie.se3_retract((poses.q, poses.t), -dp[:, :6])
        v = poses.v - dp[:, 6:9] if config.vel_in_state else poses.v
        b = poses.b - dp[:, 9:15] if config.bias_in_state else poses.b
        poses = dataclasses.replace(poses, q=q, t=t, v=v, b=b)

        lms = problem.lms
        if config.lm_size:
            lmsz = config.lm_size
            L = lms.x.shape[0]
            dl = delta_l.reshape(L, lmsz) * scale
            if lmsz == 1:
                rho_new = lms.x[:, 3] - dl[:, 0]
                neg = (rho_new < 0) & lms.active
                rho = torch.where(neg, lms.x[:, 3], rho_new)
                lms = dataclasses.replace(
                    lms, x=torch.cat([lms.x[:, :3], rho[:, None]], dim=1),
                    reliable=lms.reliable & ~neg)
            else:
                x = torch.cat([lms.x[:, :3] - dl, lms.x[:, 3:]], dim=1)
                lms = dataclasses.replace(lms, x=x)

        rig = problem.rig
        if config.calib_dim:
            dk = delta_p[P * D:] * scale
            cs = config.calib_size
            if cs:
                params = rig.params.clone()
                params[0, :cs] = rig.params[0, :cs] + (-dk[:cs])
                rig = dataclasses.replace(rig, params=params)
            if config.do_tvs:
                dtvs = dk[config.tvs_offset: config.tvs_offset + 6]
                q0, t0 = lie.se3_retract((rig.tvs_q[0], rig.tvs_t[0]), -dtvs)
                tvs_q, tvs_t = rig.tvs_q.clone(), rig.tvs_t.clone()
                tvs_q[0], tvs_t[0] = q0, t0
                rig = dataclasses.replace(rig, tvs_q=tvs_q, tvs_t=tvs_t)
            if cs and config.lm_size == 1:
                ray = cam_mod.unproject(rig.params[lms.ref_cam],
                                        rig.model[lms.ref_cam], lms.z_ref)
                norm = torch.linalg.norm(lms.x[:, :3], dim=-1, keepdim=True)
                x_new = torch.cat([ray * norm, lms.x[:, 3:]], dim=1)
                use = (lms.has_z_ref & lms.active)[:, None]
                lms = dataclasses.replace(
                    lms, x=torch.where(use, x_new, lms.x))
        return dataclasses.replace(problem, poses=poses, lms=lms, rig=rig)


class IterResult(NamedTuple):
    problem: Problem          # accepted state (== input if rejected)
    pre_cost: torch.Tensor
    post_cost: torch.Tensor
    delta_norm: torch.Tensor
    accepted: torch.Tensor    # bool
    trust_radius: torch.Tensor
    solver_ok: torch.Tensor   # bool — reduced factorization succeeded
    pre_solve_norm: torch.Tensor
    post_solve_norm: torch.Tensor
    inner_trials: torch.Tensor


def _cost(problem, config, use_imu, proj_w=None, imu_c9=None, mesh=None):
    """Trial cost; `imu_c9` reuses the build's IMU covariance; with `mesh`
    (rows sharded over its ranks) the global cost."""
    with timing.span("trial"):
        return evaluate_cost(problem, config,
                             imu_eval=_imu_eval(problem, config, use_imu,
                                                False, c9=imu_c9),
                             proj_w=proj_w, mesh=mesh)


class BuildOut(NamedTuple):
    step: GnStep
    cost: torch.Tensor
    proj_w: torch.Tensor
    rhs_p: torch.Tensor
    rhs_l: torch.Tensor
    cauchy_alpha: torch.Tensor
    imu_c9: Optional[torch.Tensor]


def _commit_imu_cov(problem: Problem, config: BAConfig, imu_c9) -> Problem:
    """Store the build's covariance when
    `calculate_inertial_covariance_once` is on."""
    if imu_c9 is None or not config.calculate_inertial_covariance_once:
        return problem
    imu = dataclasses.replace(
        problem.imu, c9=imu_c9,
        c9_set=torch.ones((), dtype=torch.bool, device=imu_c9.device))
    return dataclasses.replace(problem, imu=imu)


def _fleet_split(problem: Problem, F: int):
    """(poses, landmarks) of a fused fleet of F windows: whether every
    valid projection, IMU and binary row has its pose ids inside one of F
    equal windows of P/F poses, and whether its landmark also lies in the
    matching window of L/F landmarks.  One host read."""
    P, L = problem.poses.q.shape[0], problem.lms.x.shape[0]
    Pw, Lw = P // F, max(L // F, 1)
    pr, im, bn = problem.proj, problem.imu, problem.binary
    wp = pr.pose.long() // Pw
    ref = problem.lms.ref_pose[pr.lm].long()
    pose_bad = torch.stack([
        (pr.valid & (ref // Pw != wp)).any(),
        (im.valid & (im.pose1.long() // Pw != im.pose2.long() // Pw)).any(),
        (bn.valid & (bn.pose1.long() // Pw != bn.pose2.long() // Pw)).any()])
    lm_bad = (pr.valid & (pr.lm.long() // Lw != wp)).any() | (L % F != 0)
    poses, lms = values(torch.stack([pose_bad.any(), lm_bad]))
    return not poses, not lms


def _reduced_path(problem: Problem, config: BAConfig, plan=None):
    """(path, windows): the reduced solve of a build (ba_tpu's gates,
    `ba_tpu/solver/step.py:171-196`) and the independent pose windows of
    the banded solver's fleet axis.

    With a band, no calibration block and no marginalization prior,
    `use_banded_solver` takes "fleet_dense" (F = `fleet_size` > 1 dividing
    P and L, (P/F) D <= 4096, and every row inside its window) or
    "banded"; then "schur_on_band" (a band and no calibration block; a
    prior is allowed), then "cg" (`use_cg_solver`), else "dense".  A fused
    fleet's banded solve splits into F windows only when the rows stay
    inside equal pose windows; ba_tpu splits regardless and drops the rows
    that cross (a deliberate difference).  Where the rows lie is the one
    property read from the device: the solve's `cg.BlockPlan` carries it,
    without one it is read here."""
    D, K, P, L, lm, N = dims(problem, config)
    band = 0 < config.band_width <= P and K == 0
    if (config.use_banded_solver and band
            and problem.marg.H.shape[0] != P * D):
        F = config.fleet_size
        if F == 1 or P % F:
            return "banded", 1
        if isinstance(plan, cg_mod.BlockPlan):
            poses, lms = plan.windows == F, plan.fleet is not None
        else:
            poses, lms = _fleet_split(problem, F)
        if poses and lms and (P // F) * D <= 4096:
            return "fleet_dense", F
        return "banded", F if poses else 1
    if config.schur_on_band and band:
        return "schur_on_band", 1
    if config.use_cg_solver:
        return "cg", 1
    return "dense", 1


def solve_plan(problem: Problem, config: BAConfig):
    """The segment plans of every build of a solve, on the problem's
    device: a `cg.BlockPlan` for the block-system paths (with band_S's
    plan on the banded ones, the dense fleet solve's on "fleet_dense",
    kernel 6's for CG on the card, and the banded fleet axis's window
    count), else the
    `AssemblyPlan` of the dense solve.  No host read, except one for a
    fused fleet's rows (`_fleet_split`).  Build it once per solve."""
    with timing.span("plan"):
        path, windows = _reduced_path(problem, config)
        if path == "dense":
            return assembly_plan(problem, config)
        return cg_mod.block_plan(
            problem, config, band=path in ("banded", "schur_on_band"),
            fleet=path == "fleet_dense", windows=windows,
            schur=path == "cg" and problem.poses.t.is_cuda)


def _build_and_solve(problem: Problem, config: BAConfig, use_imu: bool,
                     plan=None) -> BuildOut:
    """Assemble and solve the reduced system on the path `_reduced_path`
    picks.  `plan` is the solve's `solve_plan`; a missing plan, or one of
    the other path (the ring hands its slide's `AssemblyPlan`), is built
    here."""
    if plan is None:
        plan = solve_plan(problem, config)
    path, windows = _reduced_path(problem, config, plan)
    blocks = path != "dense"
    if isinstance(plan, cg_mod.BlockPlan) != blocks:
        plan = solve_plan(problem, config)
    imu_eval = _imu_eval(problem, config, use_imu, True)
    imu_c9 = imu_eval.c9 if imu_eval is not None else None
    if blocks:
        D, K, P, L, lm, N = dims(problem, config)
        bs, marg_H = cg_mod.assemble_blocks(problem, config, imu_eval,
                                            with_precond=path == "cg",
                                            plan=plan)
        if path == "cg":
            step = cg_mod.solve_reduced_cg(bs, marg_H, config, P, D, K)
        elif path == "fleet_dense":
            step = banded_mod.solve_reduced_fleet_dense(problem, config, bs,
                                                        P, D)
        elif path == "banded":
            if windows != config.fleet_size:
                config = dataclasses.replace(config, fleet_size=windows)
            step = banded_mod.solve_reduced_banded(problem, config, bs, P, D)
        else:
            step = banded_mod.solve_reduced_banded_dense(problem, config, bs,
                                                         P, D, marg_H)
        return BuildOut(step=step, cost=bs.cost, proj_w=bs.proj_w,
                        rhs_p=bs.rhs_p, rhs_l=bs.rhs_l,
                        cauchy_alpha=cg_mod.cauchy_factor(bs, marg_H, P, D,
                                                          K),
                        imu_c9=imu_c9)
    asm = assemble(problem, config, imu_eval=imu_eval, plan=plan)
    return BuildOut(step=solve_reduced(asm), cost=asm.cost,
                    proj_w=asm.proj_w, rhs_p=asm.rhs_p, rhs_l=asm.rhs_l,
                    cauchy_alpha=_cauchy_factor(asm), imu_c9=imu_c9)


def _cauchy_factor(asm: Assembly):
    """alpha = ||rhs||^2 / ||J rhs||^2 from the assembled blocks."""
    with timing.span("cauchy"):
        L, lm, _ = asm.V.shape
        rl = asm.rhs_l.reshape(L, lm)
        num = torch.sum(asm.rhs_p**2) + torch.sum(asm.rhs_l**2)
        den = (asm.rhs_p @ (asm.U @ asm.rhs_p)
               + 2.0 * asm.rhs_p @ (asm.W @ asm.rhs_l)
               + torch.einsum("li,lij,lj->", rl, asm.V, rl))
        return num / torch.clamp(den, min=1e-30)


def apply_robust_reweighting(problem: Problem, config: BAConfig,
                             use_imu: bool, mesh=None) -> Problem:
    """Persistent robust rescaling of unary/IMU information (IMU scale
    from IMU errors; conditioning IMU edges exempt).  With `mesh` (the
    unary and IMU rows sharded over its ranks) the medians are global:
    ba_tpu's jit-level SPMD inserts those gathers, here they are
    explicit."""
    with timing.span("reweight"):
        from ..core import robust

        if config.use_robust_norm_for_unary_residuals:
            from ..core.residuals import prior as prior_mod

            ue = prior_mod.evaluate_unary(problem, config,
                                          with_jacobians=False)
            w = robust.huber_weights(ue.err_sq, problem.unary.valid,
                                     torch.zeros_like(problem.unary.valid),
                                     config.outlier_threshold, mesh)
            unary = dataclasses.replace(
                problem.unary,
                cov_inv=problem.unary.cov_inv * w[:, None, None])
            problem = dataclasses.replace(problem, unary=unary)

        if use_imu and config.use_robust_norm_for_inertial_residuals:
            ie = _imu_eval(problem, config, True, False)
            w = robust.huber_weights(ie.err_sq, problem.imu.valid,
                                     problem.imu.cond,
                                     config.outlier_threshold, mesh)
            w = torch.where(problem.imu.cond, 1.0, w)
            imu = dataclasses.replace(problem.imu,
                                      weight=problem.imu.weight * w)
            problem = dataclasses.replace(problem, imu=imu)
        return problem


def gn_iteration(problem: Problem, config: BAConfig, use_imu: bool,
                 gn_damping: float = 1.0,
                 error_increase_allowed: bool = False,
                 plan=None) -> IterResult:
    """One damped Gauss-Newton outer iteration with rollback; `plan` is
    the solve's `solve_plan` (built here when absent)."""
    with timing.span("iteration"):
        problem = apply_robust_reweighting(problem, config, use_imu)
        built = _build_and_solve(problem, config, use_imu, plan)
        problem = _commit_imu_cov(problem, config, built.imu_c9)
        step = built.step
        candidate = apply_update(problem, config, step.delta_p, step.delta_l,
                                 scale=gn_damping)
        post = _cost(candidate, config, use_imu, built.proj_w, built.imu_c9)
        accept = (post <= built.cost) | error_increase_allowed
        out = tree_where(accept, candidate, problem)
        dn = gn_damping * torch.sqrt(torch.sum(step.delta_p**2)
                                     + torch.sum(step.delta_l**2))
        return IterResult(problem=out, pre_cost=built.cost,
                          post_cost=torch.where(accept, post, built.cost),
                          delta_norm=torch.where(accept, dn, 0.0),
                          accepted=accept,
                          trust_radius=torch.zeros_like(built.cost),
                          solver_ok=step.ok,
                          pre_solve_norm=built.cost, post_solve_norm=post,
                          inner_trials=torch.ones((), dtype=torch.int32,
                                                  device=post.device))


def _step_sums(d_gn, d_sd, Np, mesh):
    """(|d_gn|, |d_sd|, |dd|^2, d_sd . dd), dd = d_gn - d_sd, of steps
    [pose (Np) | landmarks]; with `mesh` the landmark part is the rank's
    own, its sums all-reduced in one call."""
    dd = d_gn - d_sd
    if mesh is None:
        return (torch.linalg.norm(d_gn), torch.linalg.norm(d_sd),
                torch.sum(dd * dd), torch.sum(d_sd * dd))
    parts = torch.stack([d_gn * d_gn, d_sd * d_sd, dd * dd, d_sd * dd])
    tot = parts[:, :Np].sum(dim=1) + mesh.all_reduce_sum(
        parts[:, Np:].sum(dim=1))
    return torch.sqrt(tot[0]), torch.sqrt(tot[1]), tot[2], tot[3]


def dogleg_search(problem: Problem, config: BAConfig, use_imu: bool,
                  trust_radius, d_gn, d_sd, pre_cost, proj_w, imu_c9, Np,
                  mesh=None):
    """Bounded dogleg trust-region search given the GN and Cauchy steps.
    One host read per trial.  Returns (radius, ok, d, post, n_trials).
    With `mesh` (a rank of the landmark-sharded solve: the landmark part
    of the steps is its own) the norms and trial costs are global, so
    every rank reads the same accept."""
    with timing.span("dogleg.search"):
        norm_gn, norm_sd, a, sdd = _step_sums(d_gn, d_sd, Np, mesh)
        radius = torch.where(trust_radius <= 0, norm_gn, trust_radius)

        def propose(radius):
            sd = d_sd * (radius / torch.clamp(norm_sd, min=1e-30))
            dd = d_gn - d_sd
            bq = 2.0 * sdd
            cq = norm_sd**2 - radius**2
            disc = torch.sqrt(torch.clamp(bq * bq - 4 * a * cq, min=0.0))
            beta = (-bq + disc) / torch.clamp(2 * a, min=1e-30)
            blend = d_sd + beta * dd
            return torch.where(norm_sd >= radius, sd,
                               torch.where(norm_gn <= radius, d_gn, blend))

        ok = torch.zeros((), dtype=torch.bool, device=d_gn.device)
        d = torch.zeros_like(d_gn)
        post = pre_cost
        k = 0
        while k < config.dogleg_max_inner_iterations:
            d = propose(radius)
            cand = apply_update(problem, config, d[:Np], d[Np:])
            post = _cost(cand, config, use_imu, proj_w, imu_c9, mesh)
            ok = post < pre_cost
            radius = torch.where(ok, radius * 2.0, radius * 0.5)
            k += 1
            if item(ok):
                break
        return radius, ok, d, post, k


def dogleg_iteration(problem: Problem, config: BAConfig, use_imu: bool,
                     trust_radius, plan=None) -> IterResult:
    """One dogleg outer iteration: bounded inner trust-region search;
    `plan` as in `gn_iteration`."""
    with timing.span("iteration"):
        problem = apply_robust_reweighting(problem, config, use_imu)
        built = _build_and_solve(problem, config, use_imu, plan)
        problem = _commit_imu_cov(problem, config, built.imu_c9)
        gn = built.step
        pre_cost = built.cost
        d_gn = torch.cat([gn.delta_p, gn.delta_l])
        d_sd = built.cauchy_alpha * torch.cat([built.rhs_p, built.rhs_l])
        Np = built.rhs_p.shape[0]

        radius, ok, d, post, n_trials = dogleg_search(
            problem, config, use_imu, trust_radius, d_gn, d_sd, pre_cost,
            built.proj_w, built.imu_c9, Np)

        candidate = apply_update(problem, config, d[:Np], d[Np:])
        out = tree_where(ok, candidate, problem)
        dn = torch.linalg.norm(d)
        return IterResult(problem=out, pre_cost=pre_cost,
                          post_cost=torch.where(ok, post, pre_cost),
                          delta_norm=torch.where(ok, dn, 0.0), accepted=ok,
                          trust_radius=radius, solver_ok=gn.ok,
                          pre_solve_norm=pre_cost, post_solve_norm=post,
                          inner_trials=torch.full((), n_trials,
                                                  dtype=torch.int32,
                                                  device=post.device))


def solve_fixed(problem: Problem, config: BAConfig, use_imu: bool,
                n_iters: int, gn_damping: float = 1.0, plan=None):
    """Fixed-iteration solve.  Returns (problem, costs (n_iters,),
    delta_norms (n_iters,)); the problem must be `prepare_landmarks`-ed.
    `plan` is the problem's `solve_plan`, built here when absent (the ring
    passes the slide's plan, which its marginalization reuses)."""
    with timing.span("solve", problem.poses.t):
        trust = torch.full((), config.trust_region_size,
                           dtype=problem.poses.t.dtype,
                           device=problem.poses.t.device)
        if plan is None:
            plan = solve_plan(problem, config)
        costs, dns = [], []
        for _ in range(n_iters):
            if config.use_dogleg:
                res = dogleg_iteration(problem, config, use_imu, trust, plan)
                trust = res.trust_radius
            else:
                res = gn_iteration(problem, config, use_imu, gn_damping, False,
                                   plan)
            problem = res.problem
            costs.append(res.post_cost)
            dns.append(res.delta_norm)
        return problem, torch.stack(costs), torch.stack(dns)


def solve_fleet(problems: Problem, config: BAConfig, use_imu: bool,
                n_iters: int, gn_damping: float = 1.0):
    """`solve_fixed` of every window of a stacked fleet (`core.problem.
    stack_problems`, leading axis B), each with its own robust medians,
    trust region and costs: ba_tpu's vmap, a loop over the windows here
    (the fused `concat_problems` route is the fast one).  Returns the
    stacked (problems, costs (B, n_iters), delta_norms (B, n_iters))."""
    from ..core.problem import stack_problems
    from ..utils.tree import tree_map

    outs = [solve_fixed(tree_map(lambda a: a[b], problems), config, use_imu,
                        n_iters, gn_damping)
            for b in range(problems.poses.q.shape[0])]
    return (stack_problems([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


# OptimizationResult codes (reference enum); mapped to Summary.result.
_RUNNING, _SUCCESS, _ERR_INC, _ERR_CHG, _PARAM_CHG, _FACT_ERR = range(6)
_RESULT_NAMES = {
    _RUNNING: "Success",            # stopped at max_iter, still improving
    _SUCCESS: "Success",
    _ERR_INC: "ErrorIncreased",
    _ERR_CHG: "ErrorChangeBelowThreshold",
    _PARAM_CHG: "ParamChangeBelowThreshold",
    _FACT_ERR: "FactorizationError",
}


def _status_code(res: IterResult, config: BAConfig, tiny=1e-30):
    """Exit-criteria status of one iteration, as a device scalar."""
    pre, post, dn = res.pre_cost, res.post_cost, res.delta_norm
    rel = (post - pre).abs() / torch.clamp(pre, min=tiny)
    code = torch.full((), _RUNNING, dtype=torch.int64, device=pre.device)
    code = torch.where(dn < config.param_change_threshold, _PARAM_CHG, code)
    code = torch.where((pre > 0) & (rel < config.error_change_threshold),
                       _ERR_CHG, code)
    code = torch.where(~res.accepted, _ERR_INC, code)
    return torch.where(~res.solver_ok, _FACT_ERR, code)


def solve_adaptive(problem: Problem, config: BAConfig, use_imu: bool,
                   max_iter: int, gn_damping: float = 1.0,
                   error_increase_allowed: bool = False, verbose: int = 0,
                   staging: bool = False):
    """The adaptive solve: GN/dogleg iterations until an exit criterion,
    plus the per-family error epilogue.  Each iteration reads one vector of
    scalars from the device (its exit status and costs, and the T_vs
    change while `staging` waits).

    `verbose` prints a line per iteration.  With `staging` the T_vs
    translation stays frozen until the extrinsic's change between builds
    drops below 0.01 with >= 30 poses (one more read, of the pose count).

    Returns (problem, stats) with iterations, status code, initial/final
    cost, delta_norm, the ErrorBreakdown, the last iteration's
    solve-norm trace and the config the solve ended with."""
    from .summary import error_breakdown

    with timing.span("solve", problem.poses.t):
        dtype, device = problem.poses.t.dtype, problem.poses.t.device
        problem = prepare_landmarks(problem, config)
        plan = solve_plan(problem, config)
        trust = torch.full((), config.trust_region_size, dtype=dtype,
                           device=device)
        zero = torch.zeros((), dtype=dtype, device=device)
        it, status = 0, _RUNNING
        init_c = post_c = dn = zero
        norms = (zero, zero, torch.zeros((), dtype=torch.int32, device=device))
        if staging:
            n_poses = int(item(torch.sum(problem.poses.active)))
            last_tvs = (problem.rig.tvs_q[0], problem.rig.tvs_t[0])
        while it < max_iter and status == _RUNNING:
            if config.use_dogleg:
                res = dogleg_iteration(problem, config, use_imu, trust, plan)
                trust = res.trust_radius
            else:
                res = gn_iteration(problem, config, use_imu, gn_damping,
                                   error_increase_allowed, plan)
            if it == 0:
                init_c = res.pre_cost
            problem = res.problem
            post_c, dn = res.post_cost, res.delta_norm
            norms = (res.pre_solve_norm, res.post_solve_norm, res.inner_trials)
            read = [_status_code(res, config), res.pre_cost, res.post_cost,
                    res.delta_norm, res.accepted]
            waiting = staging and not config.tvs_translation_active
            if waiting:
                tvs_now = (problem.rig.tvs_q[0], problem.rig.tvs_t[0])
                read.append(torch.linalg.norm(
                    lie.se3_log_decoupled(tvs_now, last_tvs)))
            status, pre, post, dnv, accepted, *log_dif = values(
                torch.stack([v.double() for v in read]))
            status = int(status)
            if verbose:
                print(f"  iter {it:3d}: cost {pre:12.6g} -> {post:12.6g}  "
                      f"|dx| {dnv:10.4g}  "
                      f"{'accepted' if accepted else 'REJECTED'}")
            if waiting:
                if verbose:
                    print(f"  tvs logDif {log_dif[0]:.5g}")
                if log_dif[0] < 0.01 and n_poses >= 30:
                    if verbose:
                        print("  ENABLING Tvs TRANSLATION")
                    config = dataclasses.replace(config,
                                                 tvs_translation_active=True)
                last_tvs = tvs_now
            it += 1
        eb = error_breakdown(problem, config, use_imu)
        problem = finalize_landmarks(problem, config)
        stats = dict(iterations=it, status=status, initial_cost=init_c,
                     final_cost=post_c, delta_norm=dn, breakdown=eb,
                     pre_solve_norm=norms[0], post_solve_norm=norms[1],
                     inner_trials=norms[2], config=config)
        return problem, stats


@dataclass
class Summary:
    """SolutionSummary analog (per-family totals filled by `solve`)."""

    iterations: int = 0
    initial_cost: float = 0.0
    final_cost: float = 0.0
    delta_norm: float = 0.0
    result: str = "Success"
    pre_solve_norm: float = 0.0
    post_solve_norm: float = 0.0
    inner_iterations: int = 0
    proj_error: float = 0.0
    cond_proj_error: float = 0.0
    unary_error: float = 0.0
    binary_error: float = 0.0
    inertial_error: float = 0.0
    cond_inertial_error: float = 0.0
    num_proj_residuals: int = 0
    num_cond_proj_residuals: int = 0
    num_imu_residuals: int = 0
    num_cond_imu_residuals: int = 0
    calibration_marginals: Optional[object] = None
    tvs_translation_enabled: bool = True

    @property
    def is_good(self) -> bool:
        return self.result in ("Success", "ErrorChangeBelowThreshold",
                               "ParamChangeBelowThreshold")


def _auto_band_width(problem: Problem, config: BAConfig) -> BAConfig:
    """Populate `band_width` from the problem structure when unset (skipped
    with a calibration block or when the band covers the whole window)."""
    if config.band_width or config.calib_dim:
        return config
    P = problem.poses.q.shape[0]
    b = band_width_of(problem)
    if 0 < b < P:
        return dataclasses.replace(config, band_width=b)
    return config


def _calibration_epilogue(problem: Problem, config: BAConfig,
                          use_imu: bool, summary: Summary) -> None:
    """Fill `Summary.calibration_marginals` and/or dump the reduced system:
    one more build at the solution, on the general dense path (the
    calibration block needs the dense S anyway)."""
    if not (config.calculate_calibration_marginals
            or config.write_reduced_camera_matrix):
        return
    cfg = dataclasses.replace(config, band_width=0)
    p = prepare_landmarks(problem, config)
    asm = assemble(p, cfg, imu_eval=_imu_eval(p, cfg, use_imu, True))
    if config.calculate_calibration_marginals and config.calib_dim:
        summary.calibration_marginals = calibration_marginals(
            asm, config.calib_dim).cpu().numpy()
    if config.write_reduced_camera_matrix:
        dump_system(asm, config.write_reduced_camera_matrix)


def solve(problem: Problem, config: BAConfig, max_iter: int = 10,
          gn_damping: float = 1.0, error_increase_allowed: bool = False,
          use_imu: Optional[bool] = None, verbose: int = 0):
    """Outer solve (reference Solve), on the device the problem lives on:
    `solve_adaptive`, with the T_vs translation staged when
    `tvs_translation_staging` asks for it.  Returns (problem, Summary)."""
    if use_imu is None:
        use_imu = bool(item(torch.any(problem.imu.valid)))
    config = _auto_band_width(problem, config)
    staging = (config.do_tvs and config.tvs_translation_staging
               and config.tvs_translation_active)
    if staging:
        # start with the T_vs translation frozen
        config = dataclasses.replace(config, tvs_translation_active=False)
    p, stats = solve_adaptive(problem, config, use_imu, max_iter, gn_damping,
                              error_increase_allowed, verbose, staging)
    config = stats["config"]
    summary = Summary()
    summary.iterations = stats["iterations"]
    summary.initial_cost = float(stats["initial_cost"])
    summary.final_cost = float(stats["final_cost"])
    summary.delta_norm = float(stats["delta_norm"])
    summary.result = _RESULT_NAMES[stats["status"]]
    summary.pre_solve_norm = float(stats["pre_solve_norm"])
    summary.post_solve_norm = float(stats["post_solve_norm"])
    summary.inner_iterations = int(stats["inner_trials"])
    summary.tvs_translation_enabled = config.tvs_translation_active
    _fill_breakdown(summary, stats["breakdown"])
    _calibration_epilogue(p, config, use_imu, summary)
    return p, summary


def _fill_breakdown(summary: Summary, eb) -> None:
    summary.proj_error = float(eb.proj_error)
    summary.cond_proj_error = float(eb.cond_proj_error)
    summary.unary_error = float(eb.unary_error)
    summary.binary_error = float(eb.binary_error)
    summary.inertial_error = float(eb.inertial_error)
    summary.cond_inertial_error = float(eb.cond_inertial_error)
    summary.num_proj_residuals = int(eb.num_proj)
    summary.num_cond_proj_residuals = int(eb.num_cond_proj)
    summary.num_imu_residuals = int(eb.num_imu)
    summary.num_cond_imu_residuals = int(eb.num_cond_imu)
