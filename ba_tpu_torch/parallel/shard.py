"""Sharded solves over a mesh of processes (`torch.distributed`).

Port of `ba_tpu/parallel/shard.py`.  JAX's `shard_map` runs one program
over a device mesh; here every rank is a process that holds only its own
shard of the problem (`shard_problem`): where ba_tpu's `in_specs` say
`P(AXIS)` a rank holds the k-th block of rows, where they say `P()` the
whole array.  Each `psum` is an all-reduce and each `all_gather` a gather
(`parallel/mesh.py`); the arithmetic runs on the port's kernels, as on one
card.

Two layouts:

  * row-sharded (`sharded_assemble`, `sharded_gn_iteration`): residual
    rows sharded, states replicated.  A rank's `assemble.contribution` is
    its partial normal equations (one all-reduce); the marginalization
    prior is added once after it and the solve is replicated.
  * landmark-sharded (`partition.partition_by_landmark`, then
    `shard_problem(..., landmark_sharded=True)`): a rank also holds its
    chunk of Lk landmarks and exactly their projection rows, with
    `proj.lm` in global ids.  The builds make the ids chunk-local (lm -
    k Lk) and pass the chunk's first landmark to the solver's hooks
    (`lm_offset`).  V, W, rhs_l and the back-substitution stay on the rank;
    the landmark delta comes back on its own rank (`out_specs` `P(AXIS)`),
    and `apply_update` moves each rank's own landmarks while every rank
    moves the replicated poses alike.  `_sharded_build` picks the route
    with ba_tpu's gates:
      - dense: the rank's Schur piece S_k = U_k - W_k V_k^-1 W_k^T by K5
        from its own W blocks; S, the reduced rhs, rhs_p and the cost in
        one all-reduce; a replicated Cholesky;
      - PCG (`use_cg_solver`): `cg.assemble_blocks` and `cg.pcg_solve`
        with the mesh: one all-reduce per Schur product (K6 + segsum, then
        the reduction);
      - banded (`use_banded_solver`): one all-reduce of the rank's
        (P, B, D, D) band, then the replicated `banded_pcg_solve` (K8, K9;
        K7 past its gate on the rank's problem);
      - banded + prior (`schur_on_band`): one band all-reduce, then the
        dense solve carrying the marginalization prior (K5b), the
        distributed sliding window.
    The prior, the column mask's diagonal and the Cauchy denominator's
    prior term are counted once, after the reductions.

Every value a rank branches on (accept, the trust radius, the PCG stop
test, the dogleg's trials) is the output of an all-reduce or of a
replicated solve, so the ranks stay in step; the replicated outputs are
the same bits on every rank.

The fleets use no collectives: `sharded_fleet_solve` runs each rank's own
windows of a stacked fleet (`fleet_shard`) through `step.solve_fleet`,
`sharded_ring_fleet` each rank's own rings of a list of ring schedules
through `fixedlag.run_ring`.  (ba_tpu stacks the schedules for `vmap`,
`stack_ring_schedules`; the port loops over them and needs no stack.)
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.problem import BAConfig, Problem
from ..solver import assemble as asm
from ..solver import banded as banded_mod
from ..solver import cg as cg_mod
from ..solver import step as step_mod
from ..solver.linear import solve_reduced
from ..solver.step import (BuildOut, IterResult, _commit_imu_cov, _cost,
                           _imu_eval, apply_robust_reweighting, apply_update)
from ..utils.linalg import block_diag_inv
from ..utils.tree import tree_map, tree_where
from .mesh import Mesh

_ROW_TABLES = ("proj", "unary", "binary", "imu")
_POSE_TABLES = ("unary", "binary", "imu")


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def _pad_table(table, mult: int):
    """Every leaf of a residual table padded with zero rows (invalid) to a
    multiple of `mult`; scalar leaves kept."""
    def pad(a):
        m = (-a.shape[0]) % mult if a.dim() else 0
        if not m:
            return a
        return torch.cat([a, a.new_zeros((m,) + tuple(a.shape[1:]))])

    return tree_map(pad, table)


def _block(a, k: int, n: int):
    """Rank k's block of n equal row blocks of `a` (scalars whole)."""
    if not a.dim():
        return a
    if a.shape[0] % n:
        raise ValueError(f"shard_problem: {a.shape[0]} rows do not split "
                         f"into {n} equal blocks")
    m = a.shape[0] // n
    return a[k * m: (k + 1) * m].contiguous()


def shard_problem(problem: Problem, mesh: Mesh,
                  landmark_sharded: bool = False) -> Problem:
    """Rank `mesh.rank`'s shard of a global problem: the counterpart of
    ba_tpu's `problem_shardings` + `device_put`.  The residual tables
    (`proj`, `unary`, `binary`, `imu`) are cut into `mesh.size` equal row
    blocks, with the landmark tables too when `landmark_sharded` (lay the
    problem out with `partition.partition_by_landmark` first); every other
    leaf, and every scalar, is the rank's whole copy.  The pose-space
    tables (and without `landmark_sharded` the projection table) are first
    padded to a multiple of the mesh size with invalid rows."""
    n, k = mesh.size, mesh.rank
    pad = _POSE_TABLES if landmark_sharded else _ROW_TABLES
    problem = dataclasses.replace(problem, **{
        t: _pad_table(getattr(problem, t), n) for t in pad})
    rows = _ROW_TABLES + (("lms",) if landmark_sharded else ())
    return dataclasses.replace(problem, **{
        t: tree_map(lambda a: _block(a, k, n), getattr(problem, t))
        for t in rows})


def _offset(problem: Problem, mesh: Mesh) -> int:
    """The first global landmark id of the rank's chunk."""
    return mesh.rank * problem.lms.x.shape[0]


def _localize(problem: Problem, off: int) -> Problem:
    """The problem with its projection rows' landmark ids moved by -off."""
    if not off:
        return problem
    return dataclasses.replace(problem, proj=dataclasses.replace(
        problem.proj, lm=problem.proj.lm - off))


def _path(problem: Problem, config: BAConfig) -> str:
    """The reduced solve of a sharded build (ba_tpu's `_sharded_build`
    gates): "banded", "schur_on_band", "cg" or "dense"."""
    D, K, P = config.pose_dim, config.calib_dim, problem.poses.q.shape[0]
    band = 0 < config.band_width <= P and K == 0
    if (config.use_banded_solver and band
            and problem.marg.H.shape[0] != P * D):
        return "banded"
    if config.schur_on_band and band:
        return "schur_on_band"
    return "cg" if config.use_cg_solver else "dense"


def shard_plan(problem: Problem, config: BAConfig, mesh: Mesh):
    """The segment plans of a rank's builds, from its chunk-local problem
    (`proj.lm` local), built once per solve: an `AssemblyPlan` on the dense
    route, else a `cg.BlockPlan` (band_S's plan on the banded routes with
    the rank's `lm_offset`, kernel 6's on the card on the PCG route)."""
    path = _path(problem, config)
    if path == "dense":
        return asm.assembly_plan(problem, config)
    return cg_mod.block_plan(problem, config,
                             band=path in ("banded", "schur_on_band"),
                             schur=path == "cg" and problem.poses.t.is_cuda,
                             lm_offset=_offset(problem, mesh))


# ---------------------------------------------------------------------------
# Row-sharded layout
# ---------------------------------------------------------------------------


def _assemble_rows(problem: Problem, config: BAConfig, use_imu: bool,
                   mesh: Mesh, plan=None):
    """(Assembly, imu_c9) of the row-sharded layout: the rank's partial
    normal equations all-reduced in one call, the prior added once, then
    the Schur step (K5) on the replicated sums."""
    if plan is None:
        plan = asm.assembly_plan(problem, config)
    cmask = asm.col_mask(problem, config)
    imu_eval = _imu_eval(problem, config, use_imu, True)
    contrib, w = asm.contribution(problem, config, imu_eval, cmask, plan,
                                  mesh)
    flat = mesh.all_reduce_sum(torch.cat([t.reshape(-1) for t in contrib]))
    parts, i = [], 0
    for t in contrib:
        parts.append(flat[i: i + t.numel()].reshape(t.shape))
        i += t.numel()
    contrib = asm.Contribution(*parts)
    # the marginalization prior is a replicated factor, not a sum over rows
    contrib = asm._add(contrib, asm.marg_contribution(
        problem, config, cmask.to(contrib.U.dtype)))
    return (asm.finish(contrib, cmask, w),
            imu_eval.c9 if imu_eval is not None else None)


def sharded_assemble(problem: Problem, config: BAConfig, use_imu: bool,
                     mesh: Mesh, plan=None) -> asm.Assembly:
    """The replicated Assembly of a row-sharded problem (`shard_problem`
    without `landmark_sharded`); `plan` the rank's `assembly_plan`."""
    return _assemble_rows(problem, config, use_imu, mesh, plan)[0]


def sharded_gn_iteration(problem: Problem, config: BAConfig, use_imu: bool,
                         mesh: Mesh, gn_damping: float = 1.0,
                         plan=None) -> IterResult:
    """One GN iteration of the row-sharded layout: sharded evaluation, one
    all-reduce of the normal equations, replicated solve and update.  A
    rejected step reports the committed cost and a zero step (ba_tpu's
    contract, `ba_tpu/parallel/shard.py:144-150`)."""
    problem = apply_robust_reweighting(problem, config, use_imu, mesh)
    a, imu_c9 = _assemble_rows(problem, config, use_imu, mesh, plan)
    problem = _commit_imu_cov(problem, config, imu_c9)
    step = solve_reduced(a)
    candidate = apply_update(problem, config, step.delta_p, step.delta_l,
                             scale=gn_damping)
    post = _cost(candidate, config, use_imu, a.proj_w, imu_c9, mesh)
    accept = (post <= a.cost) & step.ok
    dn = gn_damping * torch.sqrt(torch.sum(step.delta_p**2)
                                 + torch.sum(step.delta_l**2))
    return _result(problem, candidate, accept, a.cost, post, dn, step.ok)


def _result(problem, candidate, accept, cost, post, dn, ok, radius=None,
            trials=1) -> IterResult:
    return IterResult(problem=tree_where(accept, candidate, problem),
                      pre_cost=cost,
                      post_cost=torch.where(accept, post, cost),
                      delta_norm=torch.where(accept, dn, 0.0),
                      accepted=accept,
                      trust_radius=(torch.zeros_like(cost) if radius is None
                                    else radius),
                      solver_ok=ok, pre_solve_norm=cost,
                      post_solve_norm=post,
                      inner_trials=torch.full((), trials, dtype=torch.int32,
                                              device=cost.device))


# ---------------------------------------------------------------------------
# Landmark-sharded builds: the rank's problem has chunk-local `proj.lm`
# ---------------------------------------------------------------------------


def _build_dense(problem, config, use_imu, mesh, plan, off, dogleg):
    """The dense route: the rank's Schur piece by K5 from its own W
    columns, one all-reduce of (S, rhs_sc, rhs_p, cost), the prior and the
    column mask once, a replicated Cholesky, the rank's back-substitution.
    With `dogleg`, the Cauchy factor from the rank's pieces (one more
    all-reduce of two scalars)."""
    D, K, P, L, lm, N = asm.dims(problem, config)
    dtype = problem.poses.t.dtype
    cmask = asm.col_mask(problem, config)
    imu_eval = _imu_eval(problem, config, use_imu, True)
    full, w = asm.contribution(problem, config, imu_eval, cmask, plan, mesh,
                               off)
    vinv = block_diag_inv(full.V)
    S_k, rhs_k = asm.schur_step(full.U, full.W, vinv, full.rhs_p,
                                full.rhs_l)
    red = mesh.all_reduce_sum(torch.cat([S_k.reshape(-1), rhs_k, full.rhs_p,
                                         full.cost.reshape(1)]))
    S = red[: N * N].reshape(N, N)
    rhs_sc, rhs_p, cost = red[N * N: N * N + N], red[N * N + N: -1], red[-1]
    marg = asm.marg_contribution(problem, config, cmask.to(dtype))
    S = S + marg.U + torch.diag(torch.where(cmask, 0.0, 1e6).to(dtype))
    rhs_sc = torch.where(cmask, rhs_sc + marg.rhs_p, 0.0)
    rhs_p = rhs_p + marg.rhs_p
    cost = cost + marg.cost
    a = asm.Assembly(S=S, rhs_sc=rhs_sc, U=full.U, rhs_p=rhs_p, W=full.W,
                     V=full.V, vinv=vinv, rhs_l=full.rhs_l, col_mask=cmask,
                     cost=cost, proj_w=w)
    alpha = None
    if dogleg:
        rl = full.rhs_l.reshape(L, lm)
        num_l, den = mesh.all_reduce_sum(torch.stack([
            torch.sum(full.rhs_l**2),
            rhs_p @ (full.U @ rhs_p) + 2.0 * rhs_p @ (full.W @ full.rhs_l)
            + torch.einsum("li,lij,lj->", rl, full.V, rl)]))
        den = den + rhs_p @ (marg.U @ rhs_p)
        alpha = (torch.sum(rhs_p**2) + num_l) / torch.clamp(den, min=1e-30)
    return BuildOut(step=solve_reduced(a), cost=cost, proj_w=w, rhs_p=rhs_p,
                    rhs_l=full.rhs_l, cauchy_alpha=alpha,
                    imu_c9=imu_eval.c9 if imu_eval is not None else None)


def _build_blocks(problem, config, use_imu, mesh, plan, off, dogleg, path):
    """The PCG and banded routes on the rank's block system."""
    D, K, P, L, lm, N = asm.dims(problem, config)
    imu_eval = _imu_eval(problem, config, use_imu, True)
    bs, marg_H = cg_mod.assemble_blocks(problem, config, imu_eval,
                                        with_precond=path == "cg", plan=plan,
                                        mesh=mesh, lm_offset=off)
    if path == "cg":
        step = cg_mod.solve_reduced_cg(bs, marg_H, config, P, D, K, mesh)
    else:
        band = banded_mod.band_S(problem, config, bs, P, D,
                                 add_identity=False, plan=plan.band,
                                 lm_offset=off)
        band = mesh.all_reduce_sum(band.contiguous())
        band = banded_mod.band_add_identity(band, bs.col_mask, P, D)
        if path == "banded":
            delta_p, ok = banded_mod.banded_pcg_solve(
                band, bs.rhs_sc, bs.col_mask, config, P, D)
        else:
            delta_p, ok = banded_mod.banded_dense_solve(
                band, bs.rhs_sc, bs.col_mask, marg_H)
        step = step_mod.GnStep(
            delta_p=delta_p, ok=ok,
            delta_l=cg_mod.back_substitute_blocks(bs, delta_p, P, D, 0))
    alpha = None
    if dogleg:
        alpha = cg_mod.cauchy_factor(bs, marg_H, P, D, K, mesh)
    return BuildOut(step=step, cost=bs.cost, proj_w=bs.proj_w,
                    rhs_p=bs.rhs_p, rhs_l=bs.rhs_l, cauchy_alpha=alpha,
                    imu_c9=imu_eval.c9 if imu_eval is not None else None)


def _sharded_build(problem, config, use_imu, mesh, plan, dogleg=False):
    """Dispatch a landmark-sharded build (`_path`) on the rank's
    chunk-local problem and its `shard_plan`."""
    path = _path(problem, config)
    off = _offset(problem, mesh)
    if path == "dense":
        return _build_dense(problem, config, use_imu, mesh, plan, off,
                            dogleg)
    return _build_blocks(problem, config, use_imu, mesh, plan, off, dogleg,
                         path)


def _global_norm(dp, dl, mesh):
    """|[dp | dl]| with dp replicated and dl the rank's own."""
    return torch.sqrt(torch.sum(dp**2) + mesh.all_reduce_sum(
        torch.sum(dl**2).reshape(1))[0])


def _gn_lm(problem, config, use_imu, mesh, gn_damping, plan):
    problem = apply_robust_reweighting(problem, config, use_imu, mesh)
    built = _sharded_build(problem, config, use_imu, mesh, plan)
    problem = _commit_imu_cov(problem, config, built.imu_c9)
    step = built.step
    candidate = apply_update(problem, config, step.delta_p, step.delta_l,
                             scale=gn_damping)
    post = _cost(candidate, config, use_imu, built.proj_w, built.imu_c9,
                 mesh)
    accept = (post <= built.cost) & step.ok
    dn = gn_damping * _global_norm(step.delta_p, step.delta_l, mesh)
    return _result(problem, candidate, accept, built.cost, post, dn, step.ok)


def _dogleg_lm(problem, config, use_imu, mesh, trust_radius, plan):
    problem = apply_robust_reweighting(problem, config, use_imu, mesh)
    built = _sharded_build(problem, config, use_imu, mesh, plan, True)
    problem = _commit_imu_cov(problem, config, built.imu_c9)
    gn = built.step
    d_gn = torch.cat([gn.delta_p, gn.delta_l])
    d_sd = built.cauchy_alpha * torch.cat([built.rhs_p, built.rhs_l])
    Np = built.rhs_p.shape[0]
    radius, ok, d, post, n_trials = step_mod.dogleg_search(
        problem, config, use_imu, trust_radius, d_gn, d_sd, built.cost,
        built.proj_w, built.imu_c9, Np, mesh)
    candidate = apply_update(problem, config, d[:Np], d[Np:])
    dn = _global_norm(d[:Np], d[Np:], mesh)
    return _result(problem, candidate, ok, built.cost, post, dn, gn.ok,
                   radius, n_trials)


def _on_chunk(fn, problem, mesh, *args):
    """Run fn on the rank's chunk-local problem; the result's problem
    back in global landmark ids."""
    off = _offset(problem, mesh)
    res = fn(_localize(problem, off), *args)
    return res._replace(problem=_localize(res.problem, -off))


def sharded_gn_iteration_lm(problem: Problem, config: BAConfig,
                            use_imu: bool, mesh: Mesh,
                            gn_damping: float = 1.0,
                            plan=None) -> IterResult:
    """One GN iteration of the landmark-sharded layout (the rank's
    `shard_problem(..., landmark_sharded=True)`); `plan` the rank's
    `shard_plan` of its chunk-local problem, built here when absent.
    Accepts `(post <= cost) & ok`, and a rejected step reports the
    committed cost and a zero step, as in ba_tpu."""
    def run(p):
        return _gn_lm(p, config, use_imu, mesh, gn_damping,
                      plan if plan is not None
                      else shard_plan(p, config, mesh))

    return _on_chunk(run, problem, mesh)


def sharded_dogleg_iteration_lm(problem: Problem, config: BAConfig,
                                use_imu: bool, mesh: Mesh, trust_radius,
                                plan=None) -> IterResult:
    """One dogleg iteration of the landmark-sharded layout: the sharded
    build, then `step.dogleg_search` with global norms and one all-reduce
    of the trial cost per trial."""
    def run(p):
        return _dogleg_lm(p, config, use_imu, mesh, trust_radius,
                          plan if plan is not None
                          else shard_plan(p, config, mesh))

    return _on_chunk(run, problem, mesh)


def sharded_solve_fixed(problem: Problem, config: BAConfig, use_imu: bool,
                        mesh: Mesh, n_iters: int, gn_damping: float = 1.0):
    """Fixed-iteration solve of the landmark-sharded layout (GN, or dogleg
    with `config.use_dogleg`), the plan built once: the sharded twin of
    `step.solve_fixed`.  Returns (the rank's problem, costs (n_iters,),
    delta_norms (n_iters,)), the costs and norms replicated."""
    off = _offset(problem, mesh)
    p = _localize(problem, off)
    plan = shard_plan(p, config, mesh)
    trust = torch.full((), config.trust_region_size, dtype=p.poses.t.dtype,
                       device=p.poses.t.device)
    costs, dns = [], []
    for _ in range(n_iters):
        if config.use_dogleg:
            res = _dogleg_lm(p, config, use_imu, mesh, trust, plan)
            trust = res.trust_radius
        else:
            res = _gn_lm(p, config, use_imu, mesh, gn_damping, plan)
        p = res.problem
        costs.append(res.post_cost)
        dns.append(res.delta_norm)
    return _localize(p, -off), torch.stack(costs), torch.stack(dns)


# ---------------------------------------------------------------------------
# Fleets: independent windows or rings, each rank its own (no collectives)
# ---------------------------------------------------------------------------


def fleet_shard(fleet, mesh: Mesh):
    """The rank's block of a fleet of B windows or rings: of a list (ring
    schedules), its slice of B / size; of a stacked tree (`stack_problems`,
    every leaf with a leading fleet axis B), each leaf's block.  B must be
    a multiple of the mesh size.  The counterpart of ba_tpu's
    `fleet_shardings`."""
    if isinstance(fleet, list):
        if len(fleet) % mesh.size:
            raise ValueError(f"fleet_shard: {len(fleet)} rings do not "
                             f"split over {mesh.size} ranks")
        n = len(fleet) // mesh.size
        return fleet[mesh.rank * n: (mesh.rank + 1) * n]
    return tree_map(lambda a: _block(a, mesh.rank, mesh.size), fleet)


def sharded_fleet_solve(problems: Problem, config: BAConfig, use_imu: bool,
                        mesh: Mesh, n_iters: int, gn_damping: float = 1.0):
    """Solve the rank's windows (`fleet_shard`) of a stacked fleet with
    `step.solve_fleet`: windows never couple, so no collective runs; each
    keeps its own robust medians, trust region and costs.  Returns the
    rank's (problems, costs (B/size, n_iters), delta_norms)."""
    return step_mod.solve_fleet(fleet_shard(problems, mesh), config,
                                use_imu, n_iters, gn_damping)


def sharded_ring_fleet(schedules, config: BAConfig, use_imu: bool,
                       mesh: Mesh, iters_per_slide: int,
                       gn_damping: float = 1.0):
    """Run the rank's ring pipelines (`fleet_shard` of the list of
    `fixedlag.RingSchedule`s, one stream each) through `fixedlag.run_ring`,
    with no collective.  Returns the rank's [(final_carry, outs)]."""
    from ..solver.fixedlag import run_ring

    return [run_ring(s, config, use_imu, iters_per_slide, gn_damping)
            for s in fleet_shard(schedules, mesh)]
