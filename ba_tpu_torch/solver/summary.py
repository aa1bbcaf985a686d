"""Solution diagnostics: per-family error totals and per-landmark outlier
ratios (port of `ba_tpu/solver/summary.py:error_breakdown` and
`landmark_outlier_ratio`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import robust
from ..core.problem import BAConfig, Problem
from ..core.residuals import imu as imu_mod
from ..core.residuals import prior, reprojection
from .assemble import seg_sum_blocks


class ErrorBreakdown(NamedTuple):
    """Weighted squared-error totals per residual family, conditioning
    populations separate."""

    proj_error: torch.Tensor
    cond_proj_error: torch.Tensor
    unary_error: torch.Tensor
    binary_error: torch.Tensor
    inertial_error: torch.Tensor
    cond_inertial_error: torch.Tensor
    num_proj: torch.Tensor
    num_cond_proj: torch.Tensor
    num_unary: torch.Tensor
    num_binary: torch.Tensor
    num_imu: torch.Tensor
    num_cond_imu: torch.Tensor


def error_breakdown(problem: Problem, config: BAConfig,
                    use_imu: bool) -> ErrorBreakdown:
    pe = reprojection.evaluate(problem, config, with_jacobians=False)
    pr = problem.proj
    esq = torch.where(pr.valid, pr.weight, 0.0) * pe.err_sq
    cond = pr.cond & pr.valid

    ue = prior.evaluate_unary(problem, config, with_jacobians=False)
    be = prior.evaluate_binary(problem, config, with_jacobians=False)

    zero = esq.new_zeros(())
    if use_imu:
        ie = imu_mod.evaluate(problem, config, with_jacobians=False)
        icond = problem.imu.cond & problem.imu.valid
        inertial = torch.sum(torch.where(icond, 0.0, ie.err_sq))
        cond_inertial = torch.sum(torch.where(icond, ie.err_sq, 0.0))
        num_imu = torch.sum(problem.imu.valid & ~problem.imu.cond)
        num_cond_imu = torch.sum(icond)
    else:
        inertial = cond_inertial = zero
        num_imu = num_cond_imu = torch.zeros((), dtype=torch.int64,
                                             device=esq.device)

    return ErrorBreakdown(
        proj_error=torch.sum(torch.where(cond, 0.0, esq)),
        cond_proj_error=torch.sum(torch.where(cond, esq, 0.0)),
        unary_error=torch.sum(ue.err_sq),
        binary_error=torch.sum(be.err_sq),
        inertial_error=inertial,
        cond_inertial_error=cond_inertial,
        num_proj=torch.sum(pr.valid & ~pr.cond),
        num_cond_proj=torch.sum(cond),
        num_unary=torch.sum(problem.unary.valid),
        num_binary=torch.sum(problem.binary.valid),
        num_imu=num_imu,
        num_cond_imu=num_cond_imu)


def landmark_outlier_ratio(problem: Problem, config: BAConfig) -> torch.Tensor:
    """Fraction of each landmark's projection residuals flagged as robust
    outliers (weight < 1 under the current Huber scale) — the reference's
    `LandmarkOutlierRatio(id)` accessor (BundleAdjuster.cpp:1806-1812),
    batched over all landmarks: (L,), 0 for a landmark with no residuals.
    Kernel 1 without Jacobians, then the outlier and residual counts per
    landmark in one segment sum (segsum on the card); no host read."""
    pe = reprojection.evaluate(problem, config, with_jacobians=False)
    pr = problem.proj
    L = problem.lms.x.shape[0]
    base_w = torch.where(pr.valid, pr.weight, 0.0)
    w_rob = robust.huber_weights(base_w * pe.err_sq, pr.valid, pr.cond,
                                 config.outlier_threshold)
    is_outlier = (w_rob < 1.0) & pr.valid
    counts = seg_sum_blocks(torch.stack([is_outlier, pr.valid], dim=1)
                            .to(pe.err_sq.dtype), pr.lm, L)
    return counts[:, 0] / torch.clamp(counts[:, 1], min=1.0)
