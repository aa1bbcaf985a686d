"""Sliding-window marginalization (fixed-lag VINS).

Port of `ba_tpu/solver/window.py`:

  1. select the residuals consumed by the departing poses: observations of
     landmarks anchored at a departing pose, and IMU/unary/binary edges
     touching a departing pose (only `valid` changes, never an id, so a
     slide's assembly plan serves the selection too);
  2. assemble their normal equations on the general path (plus the
     existing prior, folded in at the current estimate) and eliminate the
     departing landmarks with the Schur step (`assemble.schur_step`, K5);
  3. Schur-complement the departing pose dims with a masked inverse, all
     at static shapes:
         B = Pd S Pd + (I - Pd) + eps*Pd
         H_prior = (I-Pd) (S - S B^-1 S) (I-Pd),
         g_prior = (I-Pd) (rhs - S B^-1 rhs)
     where Pd projects onto the departing dims;
  4. symmetrize H_prior and clip its negative eigenvalues (f32 roundoff
     can make the Schur difference slightly indefinite, and an indefinite
     prior makes the window cost unbounded below).

Steps 3 and 4 are `prior_step`: on the card one launch of K11
(kernels/csrc/marginalize.cu), which inverts the departing block alone
and clips by Jacobi rotations with its stop test on the device, so a
marginalization makes no host sync.  On the CPU the plain version keeps
ba_tpu's form (`inv_ex`, `eigh`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.problem import BAConfig, MargPrior, Problem
from ..core.residuals import imu as imu_mod
from ..kernels import marginalize as k11
from ..utils.linalg import block_diag_inv
from . import assemble as asm


def _select_residuals(problem: Problem, drop):
    """Mask residual tables down to the set consumed by marginalization."""
    lm_drop = drop[problem.lms.ref_pose] & problem.lms.active
    proj = dataclasses.replace(
        problem.proj,
        valid=problem.proj.valid & lm_drop[problem.proj.lm])
    unary = dataclasses.replace(
        problem.unary,
        valid=problem.unary.valid & drop[problem.unary.pose])
    binary = dataclasses.replace(
        problem.binary,
        valid=problem.binary.valid
        & (drop[problem.binary.pose1] | drop[problem.binary.pose2]))
    imu = dataclasses.replace(
        problem.imu,
        valid=problem.imu.valid
        & (drop[problem.imu.pose1] | drop[problem.imu.pose2]))
    return dataclasses.replace(problem, proj=proj, unary=unary,
                               binary=binary, imu=imu), lm_drop


def prior_step(S, rhs, pd, eps: float):
    """(H, g) of the prior from the departing system (S, rhs) and its
    departing dims `pd`: K11 (kernels/csrc/marginalize.cu) for CUDA
    tensors, its plain version for CPU tensors."""
    if S.is_cuda:
        return k11.marginalize_prior(S, rhs, pd, eps)[:2]
    if S.device.type != "cpu":
        raise ValueError(f"prior_step: no kernel for device {S.device}")
    return k11.marginalize_prior_plain(S, rhs, pd, eps)


def marginalize(problem: Problem, config: BAConfig, use_imu: bool, drop,
                plan: asm.AssemblyPlan | None = None) -> MargPrior:
    """The new prior for departing poses `drop` ((P,) bool).  `plan` is a
    general-path `assembly_plan` of `problem` (the slide's, in the ring);
    without one, it is built here."""
    config = dataclasses.replace(config, band_width=0)
    if plan is None:
        plan = asm.assembly_plan(problem, config)
    elif plan.band_width != 0:
        raise ValueError("marginalize needs a general-path assembly plan "
                         f"(band width 0), not {plan.band_width}")
    D = config.pose_dim
    P = problem.poses.q.shape[0]
    n = P * D
    dtype = problem.poses.t.dtype

    sub, _ = _select_residuals(problem, drop)
    # all currently-active dims participate (departing poses included)
    cmask = asm.col_mask(sub, config)
    colm = cmask.to(dtype)
    ie = (imu_mod.evaluate(sub, config, with_jacobians=True) if use_imu
          else None)
    contrib, _ = asm.contribution(sub, config, ie, cmask, plan)
    contrib = asm._add(contrib, asm.marg_contribution(sub, config, colm))

    # eliminate departing landmarks (only they carry residuals here)
    S, rhs = asm.schur_step(contrib.U, contrib.W, block_diag_inv(contrib.V),
                            contrib.rhs_p, contrib.rhs_l, n=n)
    # Schur out departing pose dims, symmetrize, clip to PSD
    pd = drop.repeat_interleave(D) & cmask[:n]
    eps = 1e-9 if dtype == torch.float64 else 1e-5
    H_new, g_new = prior_step(S, rhs, pd, eps)

    poses = problem.poses
    return MargPrior(H=H_new, g=g_new, lin_q=poses.q, lin_t=poses.t,
                     lin_v=poses.v, lin_b=poses.b,
                     active=torch.ones((), dtype=torch.bool,
                                       device=H_new.device))


def apply_marginalization(problem: Problem, config: BAConfig, use_imu: bool,
                          drop,
                          plan: asm.AssemblyPlan | None = None) -> Problem:
    """Marginalize + deactivate departing states + invalidate consumed
    residuals.  `drop` is a (P,) bool mask of departing poses; `plan` as
    in `marginalize`."""
    prior = marginalize(problem, config, use_imu, drop, plan)
    lm_drop = drop[problem.lms.ref_pose] & problem.lms.active

    poses = dataclasses.replace(problem.poses,
                                active=problem.poses.active & ~drop)
    lms = dataclasses.replace(problem.lms,
                              active=problem.lms.active & ~lm_drop)
    proj = dataclasses.replace(
        problem.proj,
        valid=problem.proj.valid & ~lm_drop[problem.proj.lm]
        & ~drop[problem.proj.pose])
    unary = dataclasses.replace(
        problem.unary,
        valid=problem.unary.valid & ~drop[problem.unary.pose])
    binary = dataclasses.replace(
        problem.binary,
        valid=problem.binary.valid & ~drop[problem.binary.pose1]
        & ~drop[problem.binary.pose2])
    imu = dataclasses.replace(
        problem.imu,
        valid=problem.imu.valid & ~drop[problem.imu.pose1]
        & ~drop[problem.imu.pose2])
    return dataclasses.replace(problem, poses=poses, lms=lms, proj=proj,
                               unary=unary, binary=binary, imu=imu,
                               marg=prior)
