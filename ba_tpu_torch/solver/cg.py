"""The block system of the Schur-reduced camera system, and the
matrix-free PCG solver on it.

Port of `ba_tpu/solver/cg.py`: the weighted residual blocks and landmark
inverses that a Schur product needs, nothing quadratic in the pose count,
and the products through them

    U x   = sum_fam J_f^T (J_f x)      (per-row products, summed by pose)
    W^T x = sum_r   j_l^T (J_p x)_r    (summed by landmark)
    W z   = sum_r   J_p^T (j_l z_lm)   (summed by pose)

that the banded solvers (`solver/banded.py`) use for the Schur-reduced
rhs, the landmark back-substitution and the dogleg's Cauchy factor, and
that `solve_reduced_cg` (`use_cg_solver`, the reference's sparse reduced
solve) iterates on: block-Jacobi PCG on S x = rhs_sc with S never formed.

Every segment sum goes through `assemble.seg_sum_groups` on the plans of a
`BlockPlan`, built once per solve from the problem's static ids with no
host read (`block_plan`): segsum (kernels/csrc/segsum.cu) on the card,
the plain walk of the same plans on the CPU.  A build makes two launches
(`assemble_blocks`: the gradient, V, rhs_l and the W blocks, then W V^-1
rhs_l with the preconditioner's sums), the Cauchy factor one (U x and W z
together) and the landmark back-substitution one.  The W blocks are summed
once per build and kept in the system (`BlockSystem.wb`); ba_tpu sums them
again in `band_S` and in the preconditioner.

A Schur product (`s_matvec`) is two launches on the card: kernel 6
(kernels/csrc/schur_matvec.cu) writes the projection rows of U x - W V^-1
W^T x straight into the rhs order of the plan, one warp per landmark, and
segsum sums them by pose with the unary, binary and IMU rows; the prior,
the damping and the masked identity stay plain torch, as does the
block-Jacobi preconditioner (`_precond`, a batched D x D product).

The PCG loop (`pcg_solve`) replaces ba_tpu's `lax.while_loop` by a Python
loop whose iterations are masked once the residual test fails
(`torch.where(live, ...)`, never a multiplication by 0, which would turn a
NaN into a step): a masked iteration changes nothing, so the result and the
iteration count are the while loop's.  The host reads the stop test once
every `CG_CHECK_EVERY` (8) iterations to leave the loop: at most
ceil(cg_max_iterations / 8) host syncs per build (12 at 100 iterations),
and up to 7 masked iterations after convergence.

Not ported here: a calibration block (K > 0 raises; ROADMAP.md queue 1,
calibration on the block system) and the sharded layout (`axis_name`,
`lm_offset`; queue 1, distribution).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.problem import BAConfig, Problem
from ..core.residuals import prior
from ..kernels import schur_matvec as k6
from ..kernels import segsum
from ..utils.linalg import block_diag_inv
from ..utils.sync import item
from . import assemble as asm
from .assemble import _jtr, _outer
from .linear import GnStep

# PCG iterations between two host reads of the stop test (`pcg_solve`)
CG_CHECK_EVERY = 8


class BlockPlan(NamedTuple):
    """The segment plans of the sums through a block system, built once
    per solve (`block_plan`).  A plan appears at most once per launch, so
    the sums that share ids in one launch have plans of their own."""

    rhs: segsum.SegPlan       # (P) rows [proj pose, proj ref, unary,
    #                           binary 1, binary 2], width 6: gradient, U x
    imu_rhs: segsum.SegPlan   # (P) IMU rows [pose 1, pose 2], width D
    V: segsum.SegPlan         # (L) projection rows by landmark
    rhs_l: segsum.SegPlan     # (L) the same ids, its own counters: rhs_l,
    #                           W^T x
    wb: segsum.SegPlan        # (Nw) W blocks
    wz: segsum.SegPlan        # (P) projection rows [pose, ref]: W z
    wb_pose: segsum.SegPlan   # (P) W blocks by pose: the preconditioner
    band: Optional[object]    # banded.BandPlan of band_S, or None
    fleet: Optional[object]   # banded.FleetPlan of the dense fleet solve,
    #                           or None
    pose_ref: torch.Tensor    # (2, Nr) int32: the projection rows' pose
    #                           and ref ids, kernel 6's
    windows: int = 1          # independent pose windows of a fused fleet's
    #                           banded solve (step._reduced_path)


class BlockSystem(NamedTuple):
    """Weighted residual blocks + landmark inverses: everything a Schur
    product needs, nothing quadratic in the pose count.  The fields of
    ba_tpu's BlockSystem, then the W blocks and the plan of the sums."""

    # projection family (width-6 pose blocks)
    pj: asm.ProjBlocks
    # unary / binary (width 6)
    ju: torch.Tensor          # (Nu, 6, 6)
    u_pose: torch.Tensor
    jb1: torch.Tensor         # (Nb, 6, 6)
    jb2: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    # imu (width D)
    ji1: Optional[torch.Tensor]   # (Ni, R, D)
    ji2: Optional[torch.Tensor]
    i1: torch.Tensor
    i2: torch.Tensor
    # landmark system
    V: torch.Tensor           # (L, lm, lm)
    vinv: torch.Tensor
    rhs_l: torch.Tensor       # (L*lm,)
    # reduced rhs + masking
    rhs_p: torch.Tensor       # (N,) pose gradient (pre-Schur)
    rhs_sc: torch.Tensor      # (N,) Schur-reduced, masked
    col_mask: torch.Tensor    # (N,) bool
    # preconditioner (inverted S diagonal blocks)
    minv_pose: torch.Tensor   # (P, D, D)
    minv_cal: Optional[torch.Tensor]
    # Levenberg damping scale: diag(S) (1.0 on masked dims)
    dscale: torch.Tensor      # (N,)
    cost: torch.Tensor
    proj_w: torch.Tensor
    # the port's additions
    wb: torch.Tensor          # (Nw, 6, lm) W blocks
    plan: BlockPlan


def block_plan(problem: Problem, config: BAConfig, band: bool = False,
               fleet: bool = False, windows: int = 1) -> BlockPlan:
    """The plans of the sums through a block system of `problem`, on its
    device, with no host read; with `band`, also band_S's
    (`banded.band_plan`), with `fleet` those of the dense fleet solve
    (`banded.fleet_dense_plan`); `windows` as `step._reduced_path` found
    it.  Build it once per solve."""
    ids = asm.sum_ids(problem, config)
    P = problem.poses.q.shape[0]
    Nr = problem.proj.pose.shape[0]
    plans = {k: segsum.build_plan(*ids[k])
             for k in ("rhs", "imu_rhs", "V", "rhs_l", "wb")}
    band_plan = fleet_plan = None
    if band or fleet:
        from . import banded

        if band:
            band_plan = banded.band_plan(problem, config, ids)
        if fleet:
            fleet_plan = banded.fleet_dense_plan(problem, config, ids)
    pose_ref = ids["rhs"][0][: 2 * Nr]
    return BlockPlan(**plans,
                     wz=segsum.build_plan(pose_ref, P),
                     wb_pose=segsum.build_plan(problem.pidx.wb_pose, P),
                     band=band_plan, fleet=fleet_plan,
                     pose_ref=pose_ref.to(torch.int32).reshape(2, Nr),
                     windows=windows)


def _seg2_rows(j1, j2, u1, u2):
    """The rows ba_tpu's `_seg2` sums: j1^T u1 then j2^T u2, (n1 + n2, w);
    the caller sums them on the plan of the ids [idx1, idx2]."""
    return torch.cat([_jtr(j1, u1), _jtr(j2, u2)])


def _proj_u(bs: BlockSystem, xp6):
    """(Jp x) rows for the projection family: (Nr, 2)."""
    pj = bs.pj
    return (torch.einsum("nik,nk->ni", pj.j_m, xp6[pj.pose])
            + torch.einsum("nik,nk->ni", pj.j_r, xp6[pj.ref]))


def _wt_apply(bs: BlockSystem, xp6):
    """W^T x -> (L, lm)."""
    u = _proj_u(bs, xp6)
    return asm.seg_sum_groups([(torch.einsum("nil,ni->nl", bs.pj.j_l, u),
                                bs.plan.rhs_l)])[0]


def _w_group(bs: BlockSystem, z):
    pj = bs.pj
    v = torch.einsum("nil,nl->ni", pj.j_l, z[pj.lm])
    return (_seg2_rows(pj.j_m, pj.j_r, v, v), bs.plan.wz)


def _w_finish(yp6, D):
    return F.pad(yp6, (0, D - 6)).reshape(-1)


def _w_apply(bs: BlockSystem, z, P, D, K=0):
    """W z -> (N,) from z: (L, lm)."""
    return _w_finish(asm.seg_sum_groups([_w_group(bs, z)])[0], D)


def _pose_rows(bs: BlockSystem, xp):
    """The unary and binary rows of U x, (Nu + 2 Nb, 6), which follow the
    projection rows on `plan.rhs`, and the IMU group on `plan.imu_rhs` (or
    None); xp (P, D)."""
    xp6 = xp[:, :6]
    uu = torch.einsum("nik,nk->ni", bs.ju, xp6[bs.u_pose])
    ub = (torch.einsum("nik,nk->ni", bs.jb1, xp6[bs.b1])
          + torch.einsum("nik,nk->ni", bs.jb2, xp6[bs.b2]))
    rows = torch.cat([_jtr(bs.ju, uu), _seg2_rows(bs.jb1, bs.jb2, ub, ub)])
    imu = None
    if bs.ji1 is not None:
        ui = (torch.einsum("nik,nk->ni", bs.ji1, xp[bs.i1])
              + torch.einsum("nik,nk->ni", bs.ji2, xp[bs.i2]))
        imu = (_seg2_rows(bs.ji1, bs.ji2, ui, ui), bs.plan.imu_rhs)
    return rows, imu


def _u_groups(bs: BlockSystem, xm, P, D):
    """The rows of U x: the width-6 families on `plan.rhs`, the IMU on
    `plan.imu_rhs`."""
    xp = xm[: P * D].reshape(P, D)
    u = _proj_u(bs, xp[:, :6])
    rows, imu = _pose_rows(bs, xp)
    groups = [(torch.cat([_seg2_rows(bs.pj.j_m, bs.pj.j_r, u, u), rows]),
               bs.plan.rhs)]
    return groups + ([imu] if imu is not None else [])


def _u_finish(sums, xm, P, D, marg_H):
    y = F.pad(sums[0], (0, D - 6))
    if len(sums) > 1:
        y = y + sums[1]
    y = y.reshape(-1)
    if marg_H is not None:
        y = y + marg_H @ xm[: P * D]
    return y


def _u_apply(bs: BlockSystem, xm, P, D, K=0, marg_H=None):
    """U x (all families + marginalization prior) -> (N,)."""
    return _u_finish(asm.seg_sum_groups(_u_groups(bs, xm, P, D)), xm, P, D,
                     marg_H)


def assemble_blocks(problem: Problem, config: BAConfig, imu_eval=None,
                    with_precond: bool = True,
                    plan: Optional[BlockPlan] = None):
    """Evaluate all residual families into weighted blocks, the Schur-
    reduced rhs and, with `with_precond`, the exact block-Jacobi
    preconditioner of S (the banded solvers do not need it).  Returns
    (BlockSystem, marg_H): marg_H is the masked dense marginalization prior
    curvature, or None when the problem carries no prior.  `plan` is the
    solve's `block_plan`; without one, the build makes its own."""
    D, K, P, L, lm, N = asm.dims(problem, config)
    if K:
        raise NotImplementedError(
            "the block system with a calibration block is not ported yet "
            "(ROADMAP.md queue 1, calibration on the block system)")
    if plan is None:
        plan = block_plan(problem, config)
    dtype = problem.poses.t.dtype
    cmask = asm.col_mask(problem, config)
    colm6 = asm.col_mask(problem, config, 6).to(dtype)
    cm6 = colm6[: P * 6].reshape(P, 6)
    cmD = cmask[: P * D].reshape(P, D).to(dtype)

    pb = asm.proj_blocks(problem, config, colm6)
    ue = prior.evaluate_unary(problem, config, with_jacobians=True)
    u_pose = problem.unary.pose.long()
    ju = ue.j1 * cm6[u_pose][:, None, :]
    be = prior.evaluate_binary(problem, config, with_jacobians=True)
    b1 = problem.binary.pose1.long()
    b2 = problem.binary.pose2.long()
    jb1 = be.j1 * cm6[b1][:, None, :]
    jb2 = be.j2 * cm6[b2][:, None, :]

    i1 = problem.imu.pose1.long()
    i2 = problem.imu.pose2.long()
    if imu_eval is not None:
        ji1 = imu_eval.j1 * cmD[i1][:, None, :]
        ji2 = imu_eval.j2 * cmD[i2][:, None, :]
        imu_cost = torch.sum(imu_eval.err_sq)
    else:
        ji1 = ji2 = None
        imu_cost = torch.zeros((), dtype=dtype, device=cmD.device)

    # landmark system, gradient and W blocks: one launch
    groups = [(_outer(pb.j_l, pb.j_l), plan.V),
              (torch.einsum("nil,ni->nl", pb.j_l, pb.r), plan.rhs_l),
              (torch.cat([_seg2_rows(pb.j_m, pb.j_r, pb.r, pb.r),
                          _jtr(ju, ue.r),
                          _seg2_rows(jb1, jb2, be.r, be.r)]), plan.rhs),
              (torch.cat([_outer(pb.j_m, pb.j_l), _outer(pb.j_r, pb.j_l)]),
               plan.wb)]
    if ji1 is not None:
        groups.append((_seg2_rows(ji1, ji2, imu_eval.r, imu_eval.r),
                       plan.imu_rhs))
    sums = asm.seg_sum_groups(groups)
    V, rhs_l, yp6, Wb = sums[:4]
    vinv = block_diag_inv(V)
    yp = F.pad(yp6, (0, D - 6))
    if ji1 is not None:
        yp = yp + sums[4]
    rhs_p = yp.reshape(-1)
    cost = pb.cost + torch.sum(ue.err_sq) + torch.sum(be.err_sq) + imu_cost

    # marginalization prior: gradient + curvature (static-shape gate)
    marg = problem.marg
    marg_H = None
    if marg.H.shape[0] == P * D:
        on = marg.active.to(dtype)
        delta = asm.pose_tangent(problem.poses, marg, D)
        H = marg.H * on
        colmD = cmask[: P * D].to(dtype)
        marg_H = H * colmD[:, None] * colmD[None, :]
        rhs_p = rhs_p + (H @ delta + marg.g * on) * colmD
        cost = cost + delta @ H @ delta + 2.0 * (marg.g * on) @ delta

    bs = BlockSystem(pj=pb, ju=ju, u_pose=u_pose, jb1=jb1, jb2=jb2, b1=b1,
                     b2=b2, ji1=ji1, ji2=ji2, i1=i1, i2=i2, V=V, vinv=vinv,
                     rhs_l=rhs_l.reshape(-1), rhs_p=rhs_p, rhs_sc=rhs_p,
                     col_mask=cmask,
                     minv_pose=torch.zeros((P, D, D), dtype=dtype,
                                           device=cmD.device),
                     minv_cal=None,
                     dscale=torch.ones((N,), dtype=dtype, device=cmD.device),
                     cost=cost, proj_w=pb.w, wb=Wb, plan=plan)

    # Schur-reduced rhs: W V^-1 rhs_l, with the preconditioner's sums in
    # the same launch
    z0 = torch.einsum("lij,lj->li", vinv, rhs_l)
    groups = [_w_group(bs, z0)]
    if with_precond:
        groups.append((torch.cat([
            _outer(pb.j_m, pb.j_m), _outer(pb.j_r, pb.j_r), _outer(ju, ju),
            _outer(jb1, jb1), _outer(jb2, jb2)]), plan.rhs))
        wb_lm = problem.pidx.wb_lm.long().clamp(max=L - 1)
        groups.append((torch.einsum("nkl,nlm,nqm->nkq", Wb, vinv[wb_lm],
                                    Wb), plan.wb_pose))
        if ji1 is not None:
            groups.append((torch.cat([_outer(ji1, ji1), _outer(ji2, ji2)]),
                           plan.imu_rhs))
    sums = asm.seg_sum_groups(groups)
    rhs_sc = torch.where(cmask, rhs_p - _w_finish(sums[0], D), 0.0)
    if not with_precond:
        return bs._replace(rhs_sc=rhs_sc), marg_H

    # --- exact block-Jacobi diagonal of S -----------------------------
    diag = F.pad(sums[1] - sums[2], (0, D - 6, 0, D - 6))
    if ji1 is not None:
        diag = diag + sums[3]
    if marg_H is not None:
        diag = diag + marg_H.reshape(P, D, P, D).diagonal(
            dim1=0, dim2=2).permute(2, 0, 1)
    # masked dims -> identity rows/cols
    mD = cmD
    diag = diag * mD[:, :, None] * mD[:, None, :]
    diag = diag + torch.eye(D, dtype=dtype, device=mD.device)[None] \
        * (1.0 - mD)[:, :, None]
    lam = 1e-8 if dtype == torch.float64 else 1e-4
    dscale_p = torch.clamp(torch.diagonal(diag, dim1=-2, dim2=-1),
                           min=1e-12)
    diag = diag + lam * torch.diag_embed(dscale_p)
    dscale = torch.ones((N,), dtype=dtype, device=mD.device)
    dscale[: P * D] = dscale_p.reshape(-1)
    return bs._replace(rhs_sc=rhs_sc, minv_pose=block_diag_inv(diag),
                       dscale=dscale), marg_H


def back_substitute_blocks(bs: BlockSystem, delta_p, P, D, K=0):
    """delta_l = V^-1 (rhs_l - W^T delta_p), through the projection
    blocks."""
    L, lm, _ = bs.vinv.shape
    xp6 = delta_p[: P * D].reshape(P, D)[:, :6]
    resid = bs.rhs_l.reshape(L, lm) - _wt_apply(bs, xp6)
    return torch.einsum("lij,lj->li", bs.vinv, resid).reshape(-1)


def cauchy_factor(bs: BlockSystem, marg_H, P, D, K=0):
    """alpha = ||rhs||^2 / (rhs^T H rhs) over pose+landmark dims (the
    dogleg Cauchy step), through the blocks: U rp and W rl in one
    launch."""
    L, lm, _ = bs.V.shape
    rl = bs.rhs_l.reshape(L, lm)
    rp = torch.where(bs.col_mask, bs.rhs_p, 0.0)
    groups = _u_groups(bs, rp, P, D)
    sums = asm.seg_sum_groups(groups + [_w_group(bs, rl)])
    Ur = _u_finish(sums[:len(groups)], rp, P, D, marg_H)
    Wrl = _w_finish(sums[-1], D)
    den = (bs.rhs_p @ Ur + 2.0 * (bs.rhs_p @ Wrl)
           + torch.einsum("li,lij,lj->", rl, bs.V, rl))
    num = torch.sum(bs.rhs_p ** 2) + torch.sum(bs.rhs_l ** 2)
    return num / torch.clamp(den, min=1e-30)


def _s_groups(bs: BlockSystem, xm, P, D):
    """The rows of (U - W V^-1 W^T) x in one buffer on `plan.rhs` (the
    projection rows from kernel 6 on the card, `schur_matvec_plain` on the
    CPU, written in place; then the unary and binary rows), and the IMU
    group on `plan.imu_rhs`."""
    pj = bs.pj
    Nr = pj.j_m.shape[0]
    xp = xm[: P * D]
    rows, imu = _pose_rows(bs, xp.reshape(P, D))
    buf = xm.new_empty((2 * Nr + rows.shape[0], 6))
    if xm.is_cuda:
        pose_ref = bs.plan.pose_ref
        k6.schur_matvec(pj.j_m, pj.j_r, pj.j_l, pose_ref[0], pose_ref[1],
                        bs.vinv, xp, bs.plan.V.perm, bs.plan.V.offsets, D,
                        out=buf[: 2 * Nr])
    else:
        buf[: 2 * Nr] = k6.schur_matvec_plain(pj.j_m, pj.j_r, pj.j_l,
                                              pj.pose, pj.ref, pj.lm,
                                              bs.vinv, xp, D)
    buf[2 * Nr:] = rows
    return [(buf, bs.plan.rhs)] + ([imu] if imu is not None else [])


def s_matvec(bs: BlockSystem, x, P, D, K, lam, marg_H=None):
    """(S + lam*diag(S)) x in the masked subspace; identity on masked
    dims.  Two launches on the card: kernel 6, then segsum."""
    xm = torch.where(bs.col_mask, x, 0.0)
    y = _u_finish(asm.seg_sum_groups(_s_groups(bs, xm, P, D)), xm, P, D,
                  marg_H)
    y = y + lam * bs.dscale * xm
    return torch.where(bs.col_mask, y, x)


def _precond(bs: BlockSystem, r, P, D, K=0):
    """Block-Jacobi preconditioner: the inverted S diagonal blocks."""
    rp = r[: P * D].reshape(P, D)
    return torch.einsum("pij,pj->pi", bs.minv_pose, rp).reshape(-1)


class PcgResult(NamedTuple):
    x: torch.Tensor           # (N,) the PCG iterate
    iterations: torch.Tensor  # () int64: iterations that updated x (the
    #                           while loop's count)
    matvecs: int              # Schur products launched, masked included
    reads: int                # host reads of the stop test


def pcg_solve(bs: BlockSystem, marg_H, config: BAConfig, P, D) -> PcgResult:
    """PCG on S x = rhs_sc from x = 0 until r.r <= (cg_tolerance |b|)^2
    or `cg_max_iterations`, as ba_tpu's while loop: the iterations past the
    stop are masked, and the host reads the stop test every
    `CG_CHECK_EVERY` iterations to leave the loop."""
    dtype = bs.rhs_sc.dtype
    lam = 1e-8 if dtype == torch.float64 else 1e-4
    b = bs.rhs_sc
    x = torch.zeros_like(b)
    r = b
    z = _precond(bs, r, P, D)
    p = z
    rz = r @ z
    tol2 = (config.cg_tolerance * torch.sqrt(b @ b)) ** 2
    n_live = torch.zeros((), dtype=torch.int64, device=b.device)
    n_max = config.cg_max_iterations
    k = reads = 0
    while k < n_max:
        for _ in range(min(CG_CHECK_EVERY, n_max - k)):
            live = r @ r > tol2
            Ap = s_matvec(bs, p, P, D, 0, lam, marg_H)
            denom = p @ Ap
            alpha = torch.where(denom > 0,
                                rz / torch.where(denom > 0, denom, 1.0), 0.0)
            x = torch.where(live, x + alpha * p, x)
            r = torch.where(live, r - alpha * Ap, r)
            z = _precond(bs, r, P, D)
            rz_new = r @ z
            beta = rz_new / torch.where(rz > 0, rz, 1.0)
            p = torch.where(live, z + beta * p, p)
            rz = torch.where(live, rz_new, rz)
            n_live = n_live + live
            k += 1
        if k < n_max:
            reads += 1
            if not item(r @ r > tol2):
                break
    return PcgResult(x=x, iterations=n_live, matvecs=k, reads=reads)


def solve_reduced_cg(bs: BlockSystem, marg_H, config: BAConfig, P, D,
                     K=0) -> GnStep:
    """PCG on S delta_p = rhs_sc (`pcg_solve`), then landmark
    back-substitution; `ok` is a finite iterate."""
    x = pcg_solve(bs, marg_H, config, P, D).x
    delta_p = torch.where(torch.isfinite(x), x, 0.0)
    delta_p = torch.where(bs.col_mask, delta_p, 0.0)
    delta_l = back_substitute_blocks(bs, delta_p, P, D)
    return GnStep(delta_p=delta_p, delta_l=delta_l,
                  ok=torch.all(torch.isfinite(x)))
