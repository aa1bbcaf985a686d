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
W^T x, one thread per row in the landmark-sorted order of the plan's
`schur`, from the records `schur_pack` lays out once per build (the
block system's `pack`, in `assemble_blocks`), and segsum sums them by pose
on `s_rhs` with the unary, binary and IMU rows; the prior, the damping and
the masked identity stay plain torch, as does the block-Jacobi
preconditioner (`_precond`, a batched D x D product).  The CPU path keeps
the row order (`schur_matvec_plain` on `rhs`).

Self-calibration (K = calib_dim > 0 columns after the poses): the
projection rows carry J_c, so every product through them has a (K,)
part, sum_n J_c^T (...), a plain torch reduction as in ba_tpu, except in
the Schur product on the card, where kernel 6 writes one (K,) partial per
tile and segsum adds them in tile order in the same launch (`plan.cal`).
The build sums the calibration block's W blocks by landmark on `plan.V`
(in its second launch), forms the (K, K) block Sc of S and inverts it
with `torch.linalg.inv_ex` (no host read): the preconditioner's `minv_cal`
and the damping scale of the calibration dims.

The PCG loop (`pcg_solve`) replaces ba_tpu's `lax.while_loop` by a Python
loop whose iterations are masked once the residual test fails
(`torch.where(live, ...)`, never a multiplication by 0, which would turn a
NaN into a step): a masked iteration changes nothing, so the result and the
iteration count are the while loop's.  The host reads the stop test once
every `CG_CHECK_EVERY` (8) iterations to leave the loop: at most
ceil(cg_max_iterations / 8) host syncs per build (12 at 100 iterations),
and up to 7 masked iterations after convergence.

The landmark-sharded layout (`parallel/shard.py`, ba_tpu's `axis_name`
and `lm_offset`): a rank passes its `mesh` and `lm_offset`, the first
landmark of its chunk, with its `proj.lm` already chunk-local.  V, vinv,
rhs_l and the back-substitution stay on the rank; `assemble_blocks`
all-reduces rhs_p and the cost in one call, W V^-1 rhs_l with the
preconditioner's diagonal blocks and Sc in another, and clips the W block
table to the chunk (`assemble.local_wb_lm`); `s_matvec` all-reduces one
(N,) vector per Schur product and `cauchy_factor` two scalars.  The
marginalization prior is a replicated term, added once after each
reduction.  Every value the PCG loop branches on is then replicated, so
the ranks read the same stop test.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.problem import BAConfig, Problem
from ..core.residuals import prior
from ..kernels import schur_matvec as k6
from ..kernels import segsum
from ..utils import timing
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
    windows: int = 1          # independent pose windows of a fused fleet's
    #                           banded solve (step._reduced_path)
    schur: Optional[k6.SchurPlan] = None  # kernel 6's row order: the
    #                           projection rows sorted by landmark, cut into
    #                           tiles (the CG path on the card), or None
    s_rhs: Optional[segsum.SegPlan] = None  # (P) rows [schur.out_pose,
    #                           unary, binary 1, binary 2]: the Schur product
    #                           on the card, or None
    cal: Optional[segsum.SegPlan] = None  # (1) kernel 6's tiles: the
    #                           calibration part of the Schur product on the
    #                           card (K > 0), or None


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
    pack: Optional[k6.SchurPack] = None   # kernel 6's records of the build
    #                           (`k6.schur_pack`) when the plan has `schur`
    #                           and the blocks lie on the card


def block_plan(problem: Problem, config: BAConfig, band: bool = False,
               fleet: bool = False, windows: int = 1,
               schur: bool = False, lm_offset: int = 0) -> BlockPlan:
    """The plans of the sums through a block system of `problem`, on its
    device, with no host read; with `band`, also band_S's
    (`banded.band_plan`), with `fleet` those of the dense fleet solve
    (`banded.fleet_dense_plan`), with `schur` kernel 6's row order and the
    segsum plan of its rows (the CG path on the card); `windows` as
    `step._reduced_path` found it; `lm_offset` the first landmark of a
    rank's chunk (band_S's plan).  Build it once per solve."""
    ids = asm.sum_ids(problem, config)
    P = problem.poses.q.shape[0]
    Nr = problem.proj.pose.shape[0]
    plans = {k: segsum.build_plan(*ids[k])
             for k in ("rhs", "imu_rhs", "V", "rhs_l", "wb")}
    band_plan = fleet_plan = None
    if band or fleet:
        from . import banded

        if band:
            band_plan = banded.band_plan(problem, config, ids,
                                         lm_offset=lm_offset)
        if fleet:
            fleet_plan = banded.fleet_dense_plan(problem, config, ids)
    rhs_ids = ids["rhs"][0]
    k6_plan = s_rhs = cal = None
    if schur:
        k6_plan = k6.schur_plan(rhs_ids[:Nr], rhs_ids[Nr: 2 * Nr],
                                problem.proj.lm, ids["V"][1],
                                plans["V"].perm)
        s_rhs = segsum.build_plan(
            torch.cat([k6_plan.out_pose, rhs_ids[2 * Nr:]]), P)
        if config.calib_dim:
            cal = segsum.build_plan(
                torch.zeros(k6_plan.tiles.shape[0] - 1, dtype=torch.long,
                            device=rhs_ids.device), 1)
    return BlockPlan(**plans,
                     wz=segsum.build_plan(rhs_ids[: 2 * Nr], P),
                     wb_pose=segsum.build_plan(problem.pidx.wb_pose, P),
                     band=band_plan, fleet=fleet_plan, windows=windows,
                     schur=k6_plan, s_rhs=s_rhs, cal=cal)


def _seg2_rows(j1, j2, u1, u2):
    """The rows ba_tpu's `_seg2` sums: j1^T u1 then j2^T u2, (n1 + n2, w);
    the caller sums them on the plan of the ids [idx1, idx2]."""
    return torch.cat([_jtr(j1, u1), _jtr(j2, u2)])


def _proj_u(bs: BlockSystem, xp6, xk=None):
    """(Jp x) rows for the projection family: (Nr, 2); xk the calibration
    part of x (used when the blocks carry J_c)."""
    pj = bs.pj
    u = (torch.einsum("nik,nk->ni", pj.j_m, xp6[pj.pose])
         + torch.einsum("nik,nk->ni", pj.j_r, xp6[pj.ref]))
    if pj.j_c is not None:
        u = u + torch.einsum("nik,k->ni", pj.j_c, xk)
    return u


def _cal_sum(bs: BlockSystem, v):
    """The calibration part of J^T v over the projection rows: (K,), or
    None without a calibration block."""
    if bs.pj.j_c is None:
        return None
    return torch.einsum("nik,ni->k", bs.pj.j_c, v)


def _wt_apply(bs: BlockSystem, xp6, xk=None):
    """W^T x -> (L, lm)."""
    u = _proj_u(bs, xp6, xk)
    return asm.seg_sum_groups([(torch.einsum("nil,ni->nl", bs.pj.j_l, u),
                                bs.plan.rhs_l)])[0]


def _w_group(bs: BlockSystem, z):
    """The rows of W z on `plan.wz` and the calibration part, (K,) or
    None."""
    pj = bs.pj
    v = torch.einsum("nil,nl->ni", pj.j_l, z[pj.lm])
    return (_seg2_rows(pj.j_m, pj.j_r, v, v), bs.plan.wz), _cal_sum(bs, v)


def _w_finish(yp6, D, yk=None):
    y = F.pad(yp6, (0, D - 6)).reshape(-1)
    return y if yk is None else torch.cat([y, yk])


def _w_apply(bs: BlockSystem, z, P, D, K=0):
    """W z -> (N,) from z: (L, lm)."""
    group, yk = _w_group(bs, z)
    return _w_finish(asm.seg_sum_groups([group])[0], D, yk)


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
    `plan.imu_rhs`; and the calibration part, (K,) or None."""
    xp = xm[: P * D].reshape(P, D)
    u = _proj_u(bs, xp[:, :6], xm[P * D:])
    rows, imu = _pose_rows(bs, xp)
    groups = [(torch.cat([_seg2_rows(bs.pj.j_m, bs.pj.j_r, u, u), rows]),
               bs.plan.rhs)]
    return groups + ([imu] if imu is not None else []), _cal_sum(bs, u)


def _u_finish(sums, xm, P, D, marg_H, yk=None):
    y = F.pad(sums[0], (0, D - 6))
    if len(sums) > 1:
        y = y + sums[1]
    y = y.reshape(-1)
    if marg_H is not None:
        y = y + marg_H @ xm[: P * D]
    return y if yk is None else torch.cat([y, yk])


def _u_apply(bs: BlockSystem, xm, P, D, K=0, marg_H=None):
    """U x (all families + marginalization prior) -> (N,)."""
    groups, yk = _u_groups(bs, xm, P, D)
    return _u_finish(asm.seg_sum_groups(groups), xm, P, D, marg_H, yk)


def assemble_blocks(problem: Problem, config: BAConfig, imu_eval=None,
                    with_precond: bool = True,
                    plan: Optional[BlockPlan] = None, mesh=None,
                    lm_offset: int = 0):
    """Evaluate all residual families into weighted blocks, the Schur-
    reduced rhs and, with `with_precond`, the exact block-Jacobi
    preconditioner of S (the banded solvers do not need it).  Returns
    (BlockSystem, marg_H): marg_H is the masked dense marginalization prior
    curvature, or None when the problem carries no prior.  `plan` is the
    solve's `block_plan`; without one, the build makes its own (with
    kernel 6's on the card when `with_precond`, as the CG path's).  On the
    card a plan with `schur` lays out kernel 6's records (`pack`, one
    launch).  `mesh` and `lm_offset`: a rank of the landmark-sharded
    layout (module docstring); rhs_p, rhs_sc, the cost and the
    preconditioner come out replicated."""
    with timing.span("build", problem.poses.t):
        D, K, P, L, lm, N = asm.dims(problem, config)
        on_card = problem.poses.t.is_cuda
        if plan is None:
            plan = block_plan(problem, config, schur=with_precond and on_card)
        dtype = problem.poses.t.dtype
        cmask = asm.col_mask(problem, config)
        colm6 = asm.col_mask(problem, config, 6).to(dtype)
        cm6 = colm6[: P * 6].reshape(P, 6)
        cmD = cmask[: P * D].reshape(P, D).to(dtype)

        pb = asm.proj_blocks(problem, config, colm6, mesh)
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
        # the calibration gradient
        rk = torch.einsum("nik,ni->k", pb.j_c, pb.r) if K else rhs_p[:0]
        if mesh is not None:
            red = mesh.all_reduce_sum(torch.cat([rhs_p, rk, cost[None]]))
            rhs_p, rk, cost = red[: P * D], red[P * D: N], red[N]

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
        if K:
            rhs_p = torch.cat([rhs_p, rk])

        pack = None
        if on_card and plan.schur is not None:    # kernel 6's records
            pack = k6.schur_pack(pb.j_m, pb.j_r, pb.j_l, plan.schur, lm,
                                 pb.j_c)
        bs = BlockSystem(pj=pb, ju=ju, u_pose=u_pose, jb1=jb1, jb2=jb2, b1=b1,
                         b2=b2, ji1=ji1, ji2=ji2, i1=i1, i2=i2, V=V, vinv=vinv,
                         rhs_l=rhs_l.reshape(-1), rhs_p=rhs_p, rhs_sc=rhs_p,
                         col_mask=cmask,
                         minv_pose=torch.zeros((P, D, D), dtype=dtype,
                                               device=cmD.device),
                         minv_cal=None,
                         dscale=torch.ones((N,), dtype=dtype,
                                           device=cmD.device),
                         cost=cost, proj_w=pb.w, wb=Wb, plan=plan, pack=pack)

        # Schur-reduced rhs: W V^-1 rhs_l, with the preconditioner's sums in
        # the same launch (and the calibration block's W blocks by landmark)
        z0 = torch.einsum("lij,lj->li", vinv, rhs_l)
        w_group, w_cal = _w_group(bs, z0)
        groups = [w_group]
        if with_precond:
            groups.append((torch.cat([
                _outer(pb.j_m, pb.j_m), _outer(pb.j_r, pb.j_r), _outer(ju, ju),
                _outer(jb1, jb1), _outer(jb2, jb2)]), plan.rhs))
            wb_lm = asm.local_wb_lm(problem.pidx.wb_lm, L,
                                    lm_offset).clamp(max=L - 1)
            groups.append((torch.einsum("nkl,nlm,nqm->nkq", Wb, vinv[wb_lm],
                                        Wb), plan.wb_pose))
            if ji1 is not None:
                groups.append((torch.cat([_outer(ji1, ji1), _outer(ji2, ji2)]),
                               plan.imu_rhs))
            if K:
                groups.append((_outer(pb.j_c, pb.j_l), plan.V))
        sums = asm.seg_sum_groups(groups)
        w_z0 = _w_finish(sums[0], D, w_cal)
        if with_precond:
            # --- exact block-Jacobi diagonal of S -------------------------
            diag = F.pad(sums[1] - sums[2], (0, D - 6, 0, D - 6))
            if ji1 is not None:
                diag = diag + sums[3]
            Wc = sums[-1] if K else None
            if K:
                # the calibration block of S: Uc - sum_l Wc_l V_l^-1 Wc_l^T
                Sc = (torch.einsum("nik,nil->kl", pb.j_c, pb.j_c)
                      - torch.einsum("lkm,lmn,lqn->kq", Wc, vinv, Wc))
        if mesh is not None:
            parts = [w_z0]
            if with_precond:
                parts += [diag.reshape(-1)] + ([Sc.reshape(-1)] if K else [])
            red = mesh.all_reduce_sum(torch.cat(parts))
            w_z0 = red[:N]
            if with_precond:
                diag = red[N: N + P * D * D].reshape(P, D, D)
                if K:
                    Sc = red[N + P * D * D:].reshape(K, K)
        rhs_sc = torch.where(cmask, rhs_p - w_z0, 0.0)
        if not with_precond:
            return bs._replace(rhs_sc=rhs_sc), marg_H

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
        minv_cal = None
        if K:
            dk = torch.clamp(torch.diagonal(Sc), min=1e-12)
            eye = torch.eye(K, dtype=dtype, device=mD.device)
            minv_cal = torch.linalg.inv_ex(Sc + lam * torch.diag(dk)
                                           + 1e-12 * eye)[0]
            dscale[P * D:] = dk
        return bs._replace(rhs_sc=rhs_sc, minv_pose=block_diag_inv(diag),
                           minv_cal=minv_cal, dscale=dscale), marg_H


def back_substitute_blocks(bs: BlockSystem, delta_p, P, D, K=0):
    """delta_l = V^-1 (rhs_l - W^T delta_p), through the projection
    blocks."""
    with timing.span("back_substitute"):
        L, lm, _ = bs.vinv.shape
        xp6 = delta_p[: P * D].reshape(P, D)[:, :6]
        resid = bs.rhs_l.reshape(L, lm) - _wt_apply(bs, xp6, delta_p[P * D:])
        return torch.einsum("lij,lj->li", bs.vinv, resid).reshape(-1)


def cauchy_factor(bs: BlockSystem, marg_H, P, D, K=0, mesh=None):
    """alpha = ||rhs||^2 / (rhs^T H rhs) over pose+landmark dims (the
    dogleg Cauchy step), through the blocks: U rp and W rl in one
    launch.  With `mesh` the landmark terms and the rows' quadratic are
    all-reduced, the prior's term counted once."""
    with timing.span("cauchy"):
        L, lm, _ = bs.V.shape
        rl = bs.rhs_l.reshape(L, lm)
        rp = torch.where(bs.col_mask, bs.rhs_p, 0.0)
        groups, u_cal = _u_groups(bs, rp, P, D)
        w_group, w_cal = _w_group(bs, rl)
        sums = asm.seg_sum_groups(groups + [w_group])
        Ur = _u_finish(sums[:len(groups)], rp, P, D,
                       None if mesh is not None else marg_H, u_cal)
        Wrl = _w_finish(sums[-1], D, w_cal)
        den = (bs.rhs_p @ Ur + 2.0 * (bs.rhs_p @ Wrl)
               + torch.einsum("li,lij,lj->", rl, bs.V, rl))
        num_l = torch.sum(bs.rhs_l ** 2)
        if mesh is not None:
            num_l, den = mesh.all_reduce_sum(torch.stack([num_l, den]))
            if marg_H is not None:
                den = den + rp[: P * D] @ (marg_H @ rp[: P * D])
        num = torch.sum(bs.rhs_p ** 2) + num_l
        return num / torch.clamp(den, min=1e-30)


def _s_groups(bs: BlockSystem, xm, P, D):
    """The rows of (U - W V^-1 W^T) x in one buffer (the projection rows,
    written in place, then the unary and binary rows), with its plan, and
    the IMU group on `plan.imu_rhs`; then the calibration part, (K,) or
    None.  On the card the projection rows come from kernel 6 on the
    build's `pack` in the order of `plan.s_rhs`, and the calibration
    part's tile partials join the groups on `plan.cal` (the calibration
    part is then None); on the CPU from `schur_matvec_plain` in the order
    of `plan.rhs`."""
    pj = bs.pj
    Nr = pj.j_m.shape[0]
    xp, xk = xm[: P * D], xm[P * D:]
    rows, imu = _pose_rows(bs, xp.reshape(P, D))
    buf = xm.new_empty((2 * Nr + rows.shape[0], 6))
    cal = yk = None
    if xm.is_cuda:
        out = k6.schur_matvec(bs.pack, bs.plan.schur, bs.vinv, xp, D,
                              out=buf[: 2 * Nr].view(Nr, 2, 6),
                              xk=xk if pj.j_c is not None else None)
        if pj.j_c is not None:
            cal = (out[1], bs.plan.cal)
        plan = bs.plan.s_rhs
    else:
        out = k6.schur_matvec_plain(pj.j_m, pj.j_r, pj.j_l, pj.pose, pj.ref,
                                    pj.lm, bs.vinv, xp, D, pj.j_c, xk)
        if pj.j_c is not None:
            out, yk = out
        buf[: 2 * Nr] = out
        plan = bs.plan.rhs
    buf[2 * Nr:] = rows
    groups = ([(buf, plan)] + ([imu] if imu is not None else [])
              + ([cal] if cal is not None else []))
    return groups, yk


def s_matvec(bs: BlockSystem, x, P, D, K, lam, marg_H=None, mesh=None):
    """(S + lam*diag(S)) x in the masked subspace; identity on masked
    dims.  Two launches on the card: kernel 6, then segsum.  With `mesh`
    the rank's partial product is all-reduced (one (N,) vector), then the
    replicated prior is applied."""
    xm = torch.where(bs.col_mask, x, 0.0)
    groups, yk = _s_groups(bs, xm, P, D)
    sums = asm.seg_sum_groups(groups)
    if K and yk is None:                  # kernel 6's tiles, summed
        yk = sums.pop().reshape(K)
    y = _u_finish(sums, xm, P, D, None if mesh is not None else marg_H, yk)
    if mesh is not None:
        mesh.all_reduce_sum(y)
        if marg_H is not None:
            y = torch.cat([y[: P * D] + marg_H @ xm[: P * D], y[P * D:]])
    y = y + lam * bs.dscale * xm
    return torch.where(bs.col_mask, y, x)


def _precond(bs: BlockSystem, r, P, D, K=0):
    """Block-Jacobi preconditioner: the inverted S diagonal blocks (the
    poses', then the calibration block's)."""
    rp = r[: P * D].reshape(P, D)
    y = torch.einsum("pij,pj->pi", bs.minv_pose, rp).reshape(-1)
    if K:
        return torch.cat([y, bs.minv_cal @ r[P * D:]])
    return y


class PcgResult(NamedTuple):
    x: torch.Tensor           # (N,) the PCG iterate
    iterations: torch.Tensor  # () int64: iterations that updated x (the
    #                           while loop's count)
    matvecs: int              # Schur products launched, masked included
    reads: int                # host reads of the stop test


def pcg_solve(bs: BlockSystem, marg_H, config: BAConfig, P, D,
              K=0, mesh=None) -> PcgResult:
    """PCG on S x = rhs_sc from x = 0 until r.r <= (cg_tolerance |b|)^2
    or `cg_max_iterations`, as ba_tpu's while loop: the iterations past the
    stop are masked, and the host reads the stop test every
    `CG_CHECK_EVERY` iterations to leave the loop.  K is the calibration
    block's width; with `mesh` each Schur product is all-reduced
    (`s_matvec`) and every other vector of the loop is replicated."""
    dtype = bs.rhs_sc.dtype
    lam = 1e-8 if dtype == torch.float64 else 1e-4
    b = bs.rhs_sc
    x = torch.zeros_like(b)
    r = b
    z = _precond(bs, r, P, D, K)
    p = z
    rz = r @ z
    tol2 = (config.cg_tolerance * torch.sqrt(b @ b)) ** 2
    n_live = torch.zeros((), dtype=torch.int64, device=b.device)
    n_max = config.cg_max_iterations
    k = reads = 0
    while k < n_max:
        for _ in range(min(CG_CHECK_EVERY, n_max - k)):
            live = r @ r > tol2
            with timing.span("pcg.product"):
                Ap = s_matvec(bs, p, P, D, K, lam, marg_H, mesh)
            denom = p @ Ap
            alpha = torch.where(denom > 0,
                                rz / torch.where(denom > 0, denom, 1.0), 0.0)
            x = torch.where(live, x + alpha * p, x)
            r = torch.where(live, r - alpha * Ap, r)
            z = _precond(bs, r, P, D, K)
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
    timing.count("pcg.products", k)
    timing.count("pcg.stop_reads", reads)
    timing.count("pcg.iterations", n_live)
    return PcgResult(x=x, iterations=n_live, matvecs=k, reads=reads)


def solve_reduced_cg(bs: BlockSystem, marg_H, config: BAConfig, P, D,
                     K=0, mesh=None) -> GnStep:
    """PCG on S delta_p = rhs_sc (`pcg_solve`), then landmark
    back-substitution (on the rank's own landmarks with `mesh`); `ok` is
    a finite iterate."""
    with timing.span("reduced.cg"):
        x = pcg_solve(bs, marg_H, config, P, D, K, mesh).x
        delta_p = torch.where(torch.isfinite(x), x, 0.0)
        delta_p = torch.where(bs.col_mask, delta_p, 0.0)
        delta_l = back_substitute_blocks(bs, delta_p, P, D, K)
        return GnStep(delta_p=delta_p, delta_l=delta_l,
                      ok=torch.all(torch.isfinite(x)))
