"""Solution diagnostics: per-family error totals (port of
`ba_tpu/solver/summary.py:error_breakdown`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.problem import BAConfig, Problem
from ..core.residuals import imu as imu_mod
from ..core.residuals import prior, reprojection


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
