"""Normal-equation assembly + Schur complement.

Port of `ba_tpu/solver/assemble.py`.  Per-residual block outer products
are summed per pose block and reduced by the Schur complement of the
block-diagonal landmark Hessian, on one of two paths:

  * banded (0 < `config.band_width` = B <= P): the blocks land on a
    (P*B, D, D) band grid, densified by a pad/reshape trick;
  * general (B == 0, or a band wider than the window): the blocks land on
    a per-pose diagonal and on the problem's unique pose-pair tables, and
    `_pair_system` scatters them into the dense system.  Projections and
    pose priors assemble at pose width 6 and are widened once
    (`expand_contribution`); IMU blocks assemble at the full width D.

On both paths the seven block sums of a build go through `seg_sum_groups`
on the segment plans of an `AssemblyPlan`, built once per solve from the
problem's static index tables: one launch of the grouped CUDA kernel
(kernels/csrc/segsum.cu) for tensors on the card, the plain walk of the
same plans on the CPU.  ba_tpu's general path sums family by family
(`proj_contribution`, `prior_contribution`, `imu_contribution`, some
thirteen sums); here the sums whose blocks share a width share a segment
space, their ids offset past each other, so that a build stays one launch.
A calibration block (K > 0, self-calibration) takes the general path: its
three sums (the pose-calibration blocks Uc, the landmark-calibration blocks
Wc, and U_cc with rhs_c over every row) join the same launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core import lie, robust
from ..core.problem import BAConfig, Problem
from ..core.residuals import prior, reprojection
from ..kernels import band_to_dense as k5b
from ..kernels import schur_finish as k5
from ..kernels import segsum
from ..utils.linalg import block_diag_inv


class Contribution(NamedTuple):
    """Additive partial sums of the normal equations."""

    U: torch.Tensor          # (N, N)
    rhs_p: torch.Tensor      # (N,)
    W: torch.Tensor          # (N, L*lm)
    V: torch.Tensor          # (L, lm, lm)
    rhs_l: torch.Tensor      # (L*lm,)
    cost: torch.Tensor       # scalar


class Assembly(NamedTuple):
    S: torch.Tensor          # (N, N) reduced camera system (masked diag set)
    rhs_sc: torch.Tensor     # (N,) Schur-reduced rhs
    U: torch.Tensor          # (N, N) pose-pose Hessian
    rhs_p: torch.Tensor      # (N,)
    W: torch.Tensor          # (N, L*lm)
    V: torch.Tensor          # (L, lm, lm)
    vinv: torch.Tensor       # (L, lm, lm)
    rhs_l: torch.Tensor      # (L*lm,)
    col_mask: torch.Tensor   # (N,) bool — optimized dims
    cost: torch.Tensor       # scalar — total weighted squared error
    proj_w: torch.Tensor     # (Nr,) effective projection weights


def dims(problem: Problem, config: BAConfig):
    D = config.pose_dim
    K = config.calib_dim
    P = problem.poses.q.shape[0]
    L = problem.lms.x.shape[0]
    lm = max(config.lm_size, 1)
    return D, K, P, L, lm, P * D + K


def col_mask(problem: Problem, config: BAConfig, width=None):
    """Optimized-dim mask; `width` selects a compact pose width."""
    D = width or config.pose_dim
    m = (problem.poses.mask[:, :D]
         & problem.poses.active[:, None]).reshape(-1)
    if config.calib_dim:
        cm = torch.ones((config.calib_dim,), dtype=torch.bool,
                        device=m.device)
        if (config.do_tvs and config.tvs_translation_staging
                and not config.tvs_translation_active):
            cm[config.tvs_offset: config.tvs_offset + 3] = False
        m = torch.cat([m, cm])
    return m


def _scatter_blocks(dst, blocks, row0, col0):
    """dst[(row0_n + i, col0_n + j)] += blocks[n, i, j] for unique block
    positions.  Blocks that reach past `dst` are dropped, as JAX drops
    out-of-range scatters (the W-block padding rows carry the landmark id
    n_lms): they are zeroed and sent to block (0, 0)."""
    br, bc = blocks.shape[-2], blocks.shape[-1]
    row0 = row0.long()
    col0 = col0.long()
    keep = ((row0 >= 0) & (row0 + br <= dst.shape[0])
            & (col0 >= 0) & (col0 + bc <= dst.shape[1]))
    blocks = torch.where(keep[:, None, None], blocks, 0.0)
    r_idx = torch.where(keep, row0, 0)[:, None, None] + torch.arange(
        br, device=dst.device)[None, :, None]
    c_idx = torch.where(keep, col0, 0)[:, None, None] + torch.arange(
        bc, device=dst.device)[None, None, :]
    return dst.index_put((r_idx, c_idx), blocks, accumulate=True)


def seg_sum_blocks(vals, ids, nseg: int):
    """Segment sum of (n, *block) values into (nseg, *block); out-of-range
    ids (< 0 or >= nseg) drop their rows.  CUDA tensors go through the
    hand-written kernel (a one-group plan built per call), CPU tensors
    through `_seg_sum_plain`."""
    shape = vals.shape
    v2 = vals.reshape(shape[0], -1).contiguous()
    if v2.is_cuda:
        out = segsum.seg_sum(v2, ids, nseg)
    else:
        out = _seg_sum_plain(v2, ids, nseg)
    return out.reshape((nseg,) + shape[1:])


def seg_sum_groups(groups):
    """[(vals (n, *block), SegPlan)] -> [(nseg, *block)]: CUDA tensors in
    one launch of the grouped kernel, CPU tensors through the plain walk
    of the same plans."""
    flat = [(v.reshape(v.shape[0], -1).contiguous(), p) for v, p in groups]
    if flat[0][0].is_cuda:
        outs = segsum.seg_sum_grouped(flat)
    else:
        outs = [segsum.plan_walk(v, p) for v, p in flat]
    return [o.reshape((p.nseg,) + v.shape[1:])
            for o, (v, p) in zip(outs, groups)]


def _seg_sum_plain(v2, ids, nseg: int):
    """The plain version of segsum: the same stable-sort CSR, then a
    padded gather of each segment's rows and a sum over them."""
    perm, offsets = segsum.segment_csr(ids, nseg)
    n, k = v2.shape
    if n == 0 or nseg == 0:
        return v2.new_zeros((nseg, k))
    counts = offsets[1:] - offsets[:-1]
    width = int(counts.max())                  # host read: plain path only
    slot = offsets[:-1, None] + torch.arange(width, device=v2.device)
    inside = slot < offsets[1:, None]
    rows = perm[torch.clamp(slot, max=n - 1)]
    return torch.where(inside[..., None], v2[rows], 0.0).sum(dim=1)


def band_to_dense(band):
    """(P, B, D, D) block band (band[p, d] = block (p, p+d)) -> dense
    symmetric (P*D, P*D).  CUDA tensors go through K5b
    (kernels/csrc/band_to_dense.cu), CPU tensors through
    `band_to_dense_plain`."""
    if band.is_cuda:
        return k5b.band_to_dense(band)
    return band_to_dense_plain(band)


def band_to_dense_plain(band):
    """The plain version of K5b, with no scatter: each block-row's strip is
    padded by D so it lands on the block diagonals after a flat reshape; a
    diagonal block rounds as (u + u^T) - u."""
    P, B, D, _ = band.shape
    Wd = P * D
    pd = (torch.arange(P, device=band.device)[:, None]
          + torch.arange(B, device=band.device)[None, :])
    band = band * (pd < P)[:, :, None, None].to(band.dtype)

    def strips(b):
        Bb = b.shape[1]
        R = b.permute(0, 2, 1, 3).reshape(P, D, Bb * D)
        R = F.pad(R, (0, Wd - Bb * D))
        R = F.pad(R.reshape(P, D * Wd), (0, D))
        return R.reshape(-1)[: Wd * Wd].reshape(Wd, Wd)

    upper = strips(band)
    # diagonal blocks appear in both `upper` and its transpose
    return upper + upper.T - strips(band[:, :1])


def _empty_contrib(N, L, lm, dtype, device) -> Contribution:
    kw = dict(dtype=dtype, device=device)
    return Contribution(U=torch.zeros((N, N), **kw),
                        rhs_p=torch.zeros((N,), **kw),
                        W=torch.zeros((N, L * lm), **kw),
                        V=torch.zeros((L, lm, lm), **kw),
                        rhs_l=torch.zeros((L * lm,), **kw),
                        cost=torch.zeros((), **kw))


def _add(a: Contribution, b: Contribution) -> Contribution:
    return Contribution(*(x + y for x, y in zip(a, b)))


class ProjBlocks(NamedTuple):
    """Weighted, column-masked per-residual projection blocks."""

    j_m: torch.Tensor        # (Nr, 2, 6)
    j_r: torch.Tensor        # (Nr, 2, 6)
    j_l: torch.Tensor        # (Nr, 2, lm)
    r: torch.Tensor          # (Nr, 2) weighted residuals
    pose: torch.Tensor       # (Nr,) int64
    ref: torch.Tensor        # (Nr,) int64
    lm: torch.Tensor         # (Nr,) int64
    w: torch.Tensor          # (Nr,) effective weights
    cost: torch.Tensor       # scalar
    j_c: Optional[torch.Tensor] = None   # (Nr, 2, K) calibration columns


def _outer(a, b):
    return torch.einsum("nik,nil->nkl", a, b)


def _jtr(j, r):
    return torch.einsum("nik,ni->nk", j, r)


def proj_blocks(problem: Problem, config: BAConfig, colm6) -> ProjBlocks:
    """Evaluate + weight + column-mask the projection family."""
    D_full, K, P, L, lm, _ = dims(problem, config)
    pe = reprojection.evaluate(problem, config, with_jacobians=True)
    pr = problem.proj
    base_w = torch.where(pr.valid, pr.weight, 0.0)
    err_sq_w = base_w * pe.err_sq
    if config.use_robust_norm_for_proj_residuals:
        w_rob = robust.huber_weights(err_sq_w, pr.valid, pr.cond,
                                     config.outlier_threshold)
    else:
        w_rob = torch.ones_like(base_w)
    w = base_w * w_rob
    sw = torch.sqrt(w)[:, None, None]

    lm_ok = problem.lms.active[pr.lm]
    if config.lm_size == 0:
        j_lm = pr.z.new_zeros((pr.z.shape[0], 2, 1))
    else:
        j_lm = torch.where(lm_ok[:, None, None], pe.j_lm, 0.0)

    pose_m = pr.pose.long()
    ref_pose = problem.lms.ref_pose[pr.lm].long()
    cm_p = colm6[: P * 6].reshape(P, 6)
    # the calibration columns' mask holds staged-frozen T_vs translation
    # dims (all ones otherwise); masking at the source keeps rhs_p zero there
    cm_k = colm6[P * 6:]
    return ProjBlocks(
        j_m=pe.j_meas * sw * cm_p[pose_m][:, None, :],
        j_r=pe.j_ref * sw * cm_p[ref_pose][:, None, :],
        j_l=j_lm * sw,
        r=pe.r * sw[:, :, 0],
        pose=pose_m, ref=ref_pose, lm=pr.lm.long(),
        w=w, cost=torch.sum(w * pe.err_sq),
        j_c=pe.j_cal * sw * cm_k[None, None, :] if K else None)


def schur_step(U, W, vinv, rhs_p, rhs_l, cmask=None, n=None):
    """(S, rhs) = (U - W V^-1 W^T, rhs_p - W V^-1 rhs_l), cut to the
    leading n rows and columns, with the column mask's 1e6 diagonal and
    zero rhs where `cmask` is given: K5 (kernels/csrc/schur_finish.cu) for
    CUDA tensors, its plain version for CPU tensors."""
    if U.is_cuda:
        return k5.schur_finish(U, W, vinv, rhs_p, rhs_l, cmask, n)
    if U.device.type != "cpu":
        raise ValueError(f"schur_step: no kernel for device {U.device}")
    return k5.schur_finish_plain(U, W, vinv, rhs_p, rhs_l, cmask, n)


def finish(contrib: Contribution, cmask, proj_w) -> Assembly:
    """Schur-complement the landmark blocks and apply the dim mask."""
    vinv = block_diag_inv(contrib.V)
    S, rhs_sc = schur_step(contrib.U, contrib.W, vinv, contrib.rhs_p,
                           contrib.rhs_l, cmask)
    return Assembly(S=S, rhs_sc=rhs_sc, U=contrib.U, rhs_p=contrib.rhs_p,
                    W=contrib.W, V=contrib.V, vinv=vinv,
                    rhs_l=contrib.rhs_l, col_mask=cmask, cost=contrib.cost,
                    proj_w=proj_w)


# ---------------------------------------------------------------------------
# Marginalization prior
# ---------------------------------------------------------------------------


def pose_tangent(poses, marg, pose_dim: int):
    """delta = x (-) lin, right tangent, flattened (P*pose_dim,)."""
    dt = poses.t - marg.lin_t
    dw = lie.so3_log(lie.quat_mul(lie.quat_conj(marg.lin_q), poses.q))
    parts = [dt, dw]
    if pose_dim >= 9:
        parts.append(poses.v - marg.lin_v)
    if pose_dim >= 15:
        parts.append(poses.b - marg.lin_b)
    return torch.cat(parts, dim=-1).reshape(-1)


def marg_contribution(problem: Problem, config: BAConfig, colm):
    """Contribution of the marginalization prior (zero when inactive):
    U += H, rhs += H delta + g, cost += d^T H d + 2 g^T d."""
    D, K, P, L, lm, N = dims(problem, config)
    out = _empty_contrib(N, L, lm, problem.poses.t.dtype,
                         problem.poses.t.device)
    m = problem.marg
    n = P * D
    if m.H.shape[0] != n:       # prior disabled at build time
        return out
    on = m.active.to(m.H.dtype)
    delta = pose_tangent(problem.poses, m, D)
    H = m.H * on
    grad = H @ delta + m.g * on
    U = out.U.clone()
    U[:n, :n] += H * colm[:n, None] * colm[None, :n]
    rhs = out.rhs_p.clone()
    rhs[:n] += grad * colm[:n]
    cost = delta @ H @ delta + 2.0 * (m.g * on) @ delta
    return out._replace(U=U, rhs_p=rhs, cost=cost)


def marg_cost(problem: Problem, config: BAConfig):
    m = problem.marg
    P = problem.poses.q.shape[0]
    if m.H.shape[0] != P * config.pose_dim:
        return problem.poses.t.new_zeros(())
    on = m.active.to(m.H.dtype)
    delta = pose_tangent(problem.poses, m, config.pose_dim)
    return on * (delta @ m.H @ delta + 2.0 * m.g @ delta)


def band_width_of(problem: Problem) -> int:
    """Host-side: block half-bandwidth + 1 of the Schur-reduced pose
    Hessian — the max over two-pose residual spans and landmark
    co-observation spans."""
    idx = problem.pidx
    b = 0
    for a_t, b_t in ((idx.pair_a, idx.pair_b), (idx.bpair_a, idx.bpair_b),
                     (idx.ipair_a, idx.ipair_b)):
        d = b_t.cpu().numpy().astype(np.int64) - a_t.cpu().numpy()
        if d.size:
            b = max(b, int(d.max()))
    wp = idx.wb_pose.cpu().numpy().astype(np.int64)
    wl = idx.wb_lm.cpu().numpy().astype(np.int64)
    if wp.size:
        n_lm = int(wl.max()) + 1
        mx = np.full(n_lm, -1, np.int64)
        mn = np.full(n_lm, np.iinfo(np.int64).max, np.int64)
        np.maximum.at(mx, wl, wp)
        np.minimum.at(mn, wl, wp)
        span = mx - mn
        b = max(b, int(span[mx >= 0].max(initial=0)))
    return b + 1


def _band_pair_blocks(j1, j2, idx1, idx2):
    """Cross-term blocks of one two-pose family: the (a, b) block oriented
    a->b, plus its transpose masked to the same-pose case (band-grid ids
    in `_band_pair_ids`)."""
    blk = _outer(j1, j2)
    blk = torch.where((idx1 > idx2)[:, None, None], blk.transpose(1, 2), blk)
    blk_t = blk.transpose(1, 2) * (idx1 == idx2)[:, None, None].to(blk.dtype)
    return torch.cat([blk, blk_t], dim=0)


def _band_pair_ids(idx1, idx2, B):
    """Band-grid ids of `_band_pair_blocks`' rows: segment a*B + (b-a)."""
    d = (idx1 - idx2).abs()
    ids = torch.minimum(idx1, idx2) * B + torch.clamp(d, max=B - 1)
    return torch.cat([ids, ids])


def _cross_blocks(j1, j2, idx1, idx2, swap, B):
    """The cross-term rows of one two-pose family.  Banded: as
    `_band_pair_blocks`.  General: the block j1^T j2 oriented a->b
    (a = the smaller pose id), one row per residual, summed per unique
    pair (`_pair_system` scatters it and its transpose)."""
    if B:
        return _band_pair_blocks(j1, j2, idx1, idx2)
    blk = _outer(j1, j2)
    return torch.where(swap[:, None, None], blk.transpose(1, 2), blk)


def _pair_system(N, P, D, diag, pairs, rhs_pose, pair_a, pair_b):
    """Dense (U, rhs) from the general path's block sums: the per-pose
    diagonal blocks (P, D, D), the per-pair blocks (n, D, D) at (a, b) and
    their transposes at (b, a), and the per-pose rhs (P, D).  This is the
    scatter half of ba_tpu's `_pair_system`; its segment sums are part of
    the build's grouped launch.  Padded pair rows repeat the position
    (0, 0) with zero blocks, so the scatter accumulates; a == b is right
    too (both cross terms land on the diagonal block)."""
    pd = torch.arange(P, device=diag.device) * D
    pair_a = pair_a.long() * D
    pair_b = pair_b.long() * D
    U = torch.zeros((N, N), dtype=diag.dtype, device=diag.device)
    U = _scatter_blocks(U, torch.cat([diag, pairs, pairs.transpose(1, 2)]),
                        torch.cat([pd, pair_a, pair_b]),
                        torch.cat([pd, pair_b, pair_a]))
    rhs = torch.zeros((N,), dtype=diag.dtype, device=diag.device)
    rhs[: P * D] = rhs_pose.reshape(-1)
    return U, rhs


def expand_contribution(c: Contribution, P: int, D: int, K: int,
                        D_c: int = 6) -> Contribution:
    """Expand a compact (P*D_c + K)-dim pose system into (P*D + K) dims:
    projection and prior Jacobians touch only the first 6 of the D pose
    dims, so they assemble at width 6 and are padded out once."""
    if D == D_c:
        return c
    n_c = P * D_c

    def expand_rows(M):
        pose = F.pad(M[:n_c].reshape(P, D_c, -1), (0, 0, 0, D - D_c))
        return torch.cat([pose.reshape(P * D, -1), M[n_c:]], dim=0)

    return c._replace(U=expand_rows(expand_rows(c.U).T).T,
                      rhs_p=expand_rows(c.rhs_p[:, None])[:, 0],
                      W=expand_rows(c.W))


class AssemblyPlan(NamedTuple):
    """The segment plans of the seven sums of a build, built once per
    solve (`assembly_plan`): every id they are made from is static across
    the iterations of a solve.  `band_width` is the build's path: > 0 the
    banded grid, 0 the general path."""

    band_width: int
    grid: segsum.SegPlan       # 6x6 pose blocks: the (P*B) band grid, or
    #                            the (P) diagonal, then the projection and
    #                            binary pair tables
    rhs: segsum.SegPlan        # (P) pose rhs
    imu_grid: segsum.SegPlan   # DxD IMU blocks: the (P*B) band grid, or
    #                            the (P) diagonal, then the IMU pair table
    imu_rhs: segsum.SegPlan    # (P) IMU rhs
    V: segsum.SegPlan          # (L) landmark blocks
    rhs_l: segsum.SegPlan      # (L) landmark rhs: V's ids, its own counters
    wb: segsum.SegPlan         # (Nw) W blocks
    # with a calibration block (K > 0), else None:
    uc: Optional[segsum.SegPlan] = None   # (P) projection rows [pose,
    #                                       ref]: the 6 x K blocks of Uc
    wc: Optional[segsum.SegPlan] = None   # (L) projection rows by
    #                                       landmark: the K x lm Wc blocks
    cc: Optional[segsum.SegPlan] = None   # (1) every projection row:
    #                                       U_cc and rhs_c


def plan_width(problem: Problem, config: BAConfig) -> int:
    """The band width a build of `problem` uses: `config.band_width` when
    the banded grid applies (0 < B <= P and no calibration block, whose
    rows couple every pose), else 0, the general path."""
    D, K, P, L, lm, N = dims(problem, config)
    if K:
        return 0
    return config.band_width if config.band_width <= P else 0


def sum_ids(problem: Problem, config: BAConfig):
    """{AssemblyPlan field: (ids, nseg)} of the seven sums of a build (ten
    with a calibration block); the rows follow the order `contribution`
    stacks values in."""
    P, L = problem.poses.q.shape[0], problem.lms.x.shape[0]
    B = plan_width(problem, config)
    pose = problem.proj.pose.long()
    ref = problem.lms.ref_pose[problem.proj.lm].long()
    b1 = problem.binary.pose1.long()
    b2 = problem.binary.pose2.long()
    i1 = problem.imu.pose1.long()
    i2 = problem.imu.pose2.long()
    lm = problem.proj.lm.long()
    pose_rows = torch.cat([pose, ref, problem.unary.pose.long(), b1, b2])
    imu_rows = torch.cat([i1, i2])
    if B:
        grid = (torch.cat([pose_rows * B, _band_pair_ids(pose, ref, B),
                           _band_pair_ids(b1, b2, B)]), P * B)
        imu_grid = (torch.cat([imu_rows * B, _band_pair_ids(i1, i2, B)]),
                    P * B)
    else:
        idx = problem.pidx
        n_pair = idx.pair_a.shape[0]
        grid = (torch.cat([pose_rows, P + problem.proj.pair.long(),
                           P + n_pair + problem.binary.pair.long()]),
                P + n_pair + idx.bpair_a.shape[0])
        imu_grid = (torch.cat([imu_rows, P + problem.imu.pair.long()]),
                    P + idx.ipair_a.shape[0])
    out = dict(
        grid=grid,
        rhs=(pose_rows, P),
        imu_grid=imu_grid,
        imu_rhs=(imu_rows, P),
        V=(lm, L),
        rhs_l=(lm, L),
        wb=(torch.cat([problem.proj.wb_meas, problem.proj.wb_ref]),
            problem.pidx.wb_pose.shape[0]))
    if config.calib_dim:
        out.update(uc=(torch.cat([pose, ref]), P), wc=(lm, L),
                   cc=(torch.zeros_like(lm), 1))
    return out


def assembly_plan(problem: Problem, config: BAConfig) -> AssemblyPlan:
    """The segment plans of a build of `problem` (banded or general, as
    `plan_width` selects), on its device, with no host read.  Build it
    once per solve and pass it to every `assemble` of that solve."""
    return AssemblyPlan(plan_width(problem, config), **{
        name: segsum.build_plan(ids, nseg)
        for name, (ids, nseg) in sum_ids(problem, config).items()})


def assemble(problem: Problem, config: BAConfig, imu_eval=None,
             plan: AssemblyPlan | None = None) -> Assembly:
    """Build the Schur-reduced normal equations at the current state, on
    the banded grid or the general path (`plan_width`).  `plan` is the
    solve's `assembly_plan`; without one, the build makes its own."""
    B = plan_width(problem, config)
    if plan is None:
        plan = assembly_plan(problem, config)
    elif plan.band_width != B:
        raise ValueError(f"assembly plan for band width {plan.band_width}, "
                         f"the build needs {B}")
    cmask = col_mask(problem, config)
    contrib, w = contribution(problem, config, imu_eval, cmask, plan)
    contrib = _add(contrib, marg_contribution(problem, config,
                                              cmask.to(contrib.U.dtype)))
    return finish(contrib, cmask, w)


def contribution(problem: Problem, config: BAConfig, imu_eval, cmask,
                 plan: AssemblyPlan):
    """The normal equations of the residual families before the Schur
    step and without the marginalization prior: (Contribution, effective
    projection weights).  The values of the seven segment sums, one
    grouped sum over `plan`, then the banded grid densified or the general
    path's blocks scattered (`plan.band_width`)."""
    D, K, P, L, lm, N = dims(problem, config)
    B = plan.band_width
    dtype = problem.poses.t.dtype
    colm = cmask.to(dtype)
    colm6 = col_mask(problem, config, 6).to(dtype)
    pb = proj_blocks(problem, config, colm6)
    cm_p = colm6[: P * 6].reshape(P, 6)

    ue = prior.evaluate_unary(problem, config, with_jacobians=True)
    u_pose = problem.unary.pose.long()
    ju = ue.j1 * cm_p[u_pose][:, None, :]
    be = prior.evaluate_binary(problem, config, with_jacobians=True)
    b1 = problem.binary.pose1.long()
    b2 = problem.binary.pose2.long()
    jb1 = be.j1 * cm_p[b1][:, None, :]
    jb2 = be.j2 * cm_p[b2][:, None, :]

    grid_vals = torch.cat([
        _outer(pb.j_m, pb.j_m), _outer(pb.j_r, pb.j_r), _outer(ju, ju),
        _outer(jb1, jb1), _outer(jb2, jb2),
        _cross_blocks(pb.j_m, pb.j_r, pb.pose, pb.ref,
                      problem.proj.pair_swap, B),
        _cross_blocks(jb1, jb2, b1, b2, problem.binary.pair_swap, B)])
    rhs_vals = torch.cat([_jtr(pb.j_m, pb.r), _jtr(pb.j_r, pb.r),
                          _jtr(ju, ue.r), _jtr(jb1, be.r), _jtr(jb2, be.r)])
    cost = pb.cost + torch.sum(ue.err_sq) + torch.sum(be.err_sq)
    groups = [(grid_vals, plan.grid), (rhs_vals, plan.rhs)]

    if imu_eval is not None:
        i1 = problem.imu.pose1.long()
        i2 = problem.imu.pose2.long()
        cm_pD = colm[: P * D].reshape(P, D)
        ji1 = imu_eval.j1 * cm_pD[i1][:, None, :]
        ji2 = imu_eval.j2 * cm_pD[i2][:, None, :]
        groups += [
            (torch.cat([_outer(ji1, ji1), _outer(ji2, ji2),
                        _cross_blocks(ji1, ji2, i1, i2,
                                      problem.imu.pair_swap, B)]),
             plan.imu_grid),
            (torch.cat([_jtr(ji1, imu_eval.r), _jtr(ji2, imu_eval.r)]),
             plan.imu_rhs)]
        cost = cost + torch.sum(imu_eval.err_sq)

    j_lm_w = pb.j_l
    groups += [
        (_outer(j_lm_w, j_lm_w), plan.V),
        (torch.einsum("nil,ni->nl", j_lm_w, pb.r), plan.rhs_l),
        (torch.cat([_outer(pb.j_m, j_lm_w), _outer(pb.j_r, j_lm_w)]),
         plan.wb)]
    if K:
        jc = pb.j_c
        Nr = jc.shape[0]
        groups += [
            (torch.cat([_outer(pb.j_m, jc), _outer(pb.j_r, jc)]), plan.uc),
            (_outer(jc, j_lm_w), plan.wc),
            (torch.cat([_outer(jc, jc).reshape(Nr, K * K), _jtr(jc, pb.r)],
                       dim=1), plan.cc)]
    sums = seg_sum_groups(groups)
    if K:
        Uc, Wc, cc = sums[-3:]
        sums = sums[:-3]
    V, rhs_l, Wb = sums[-3:]
    rhs_l = rhs_l.reshape(-1)
    idx = problem.pidx

    def dense_w(width, n):
        """W (n, L*lm) from its blocks at pose width `width`."""
        W = torch.zeros((n, L * lm), dtype=dtype, device=Wb.device)
        return _scatter_blocks(W, Wb, idx.wb_pose.long() * width,
                               idx.wb_lm.long() * lm)

    if B:
        grid = F.pad(sums[0], (0, D - 6, 0, D - 6))
        rhs = F.pad(sums[1], (0, D - 6))
        if imu_eval is not None:
            grid = grid + sums[2]
            rhs = rhs + sums[3]
        U = band_to_dense(grid.reshape(P, B, D, D))
        return Contribution(U=U, rhs_p=rhs.reshape(-1), W=dense_w(D, N),
                            V=V, rhs_l=rhs_l, cost=cost), pb.w

    N6 = P * 6 + K
    U6, rhs6 = _pair_system(N6, P, 6, sums[0][:P], sums[0][P:], sums[1],
                            torch.cat([idx.pair_a, idx.bpair_a]),
                            torch.cat([idx.pair_b, idx.bpair_b]))
    W6 = dense_w(6, N6)
    if K:
        # the calibration block: Uc by pose, U_cc and rhs_c, Wc by landmark
        # (ba_tpu's `_pair_system` with j_cal and `proj_contribution`)
        Uc = Uc.reshape(P * 6, K)
        U6[: P * 6, N6 - K:] += Uc
        U6[N6 - K:, : P * 6] += Uc.T
        U6[N6 - K:, N6 - K:] += cc[0, : K * K].reshape(K, K)
        rhs6[N6 - K:] += cc[0, K * K:]
        W6[N6 - K:] += Wc.permute(1, 0, 2).reshape(K, L * lm)
    contrib = expand_contribution(
        Contribution(U=U6, rhs_p=rhs6, W=W6, V=V, rhs_l=rhs_l,
                     cost=cost), P, D, K)
    if imu_eval is not None:
        Ui, rhs_i = _pair_system(N, P, D, sums[2][:P], sums[2][P:], sums[3],
                                 idx.ipair_a, idx.ipair_b)
        contrib = contrib._replace(U=contrib.U + Ui,
                                   rhs_p=contrib.rhs_p + rhs_i)
    return contrib, pb.w


def evaluate_cost(problem: Problem, config: BAConfig, imu_eval=None,
                  proj_w=None):
    """Total weighted squared error without Jacobians; `proj_w` carries
    the robust weights frozen at build time so a trial compares like
    against like."""
    pe = reprojection.evaluate(problem, config, with_jacobians=False)
    pr = problem.proj
    if proj_w is None:
        proj_w = torch.where(pr.valid, pr.weight, 0.0)
    cost = torch.sum(proj_w * pe.err_sq)
    ue = prior.evaluate_unary(problem, config, with_jacobians=False)
    cost = cost + torch.sum(ue.err_sq)
    be = prior.evaluate_binary(problem, config, with_jacobians=False)
    cost = cost + torch.sum(be.err_sq)
    if imu_eval is not None:
        cost = cost + torch.sum(imu_eval.err_sq)
    return cost + marg_cost(problem, config)
