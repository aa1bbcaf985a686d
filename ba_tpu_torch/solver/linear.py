"""Reduced-system solve + landmark back-substitution.

Port of `ba_tpu/solver/linear.py`: dense Jacobi-scaled Cholesky of S with
one step of iterative refinement, then the landmark deltas by
back-substitution.  The factorization is the plain large one JAX leaves to
XLA, here `torch.linalg.cholesky_ex`, whose `info` replaces the NaN test of
`cho_factor`: a failed factorization gives `ok == False` and a zero pose
step, never an exception mid-solve.  Self-calibration adds the marginal
covariance of the calibration block and the text dump of the reduced
system (the reference's `write_reduced_camera_matrix`).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

import torch

from .assemble import Assembly


class GnStep(NamedTuple):
    delta_p: torch.Tensor     # (N,)
    delta_l: torch.Tensor     # (L*lm,)
    ok: torch.Tensor          # scalar bool — factorization succeeded


def solve_reduced(asm: Assembly) -> GnStep:
    """delta_p = S^-1 rhs_sc via Jacobi-scaled Cholesky + one refinement
    step; delta_l by back-substitution."""
    S = asm.S
    dtype = S.dtype
    scal = torch.rsqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    Ss = S * scal[:, None] * scal[None, :]
    # diag(Ss) == 1 after scaling, so eps is a relative damping
    eps = 1e-8 if dtype == torch.float64 else 1e-4
    Ss = Ss + eps * torch.eye(S.shape[0], dtype=dtype, device=S.device)
    c, info = torch.linalg.cholesky_ex(Ss)
    ok = (info == 0) & torch.all(torch.isfinite(torch.diagonal(c)))

    def scaled_solve(rhs):
        y = torch.cholesky_solve((rhs * scal)[:, None], c)[:, 0]
        return y * scal

    delta_p = scaled_solve(asm.rhs_sc)
    resid = asm.rhs_sc - S @ delta_p
    delta_p = delta_p + scaled_solve(resid)
    delta_p = torch.where(torch.isfinite(delta_p) & ok, delta_p, 0.0)
    delta_p = torch.where(asm.col_mask, delta_p, 0.0)
    delta_l = back_substitute(asm, delta_p)
    return GnStep(delta_p=delta_p, delta_l=delta_l, ok=ok)


def back_substitute(asm: Assembly, delta_p) -> torch.Tensor:
    """delta_l = V^-1 (rhs_l - W^T delta_p)."""
    L, lm, _ = asm.vinv.shape
    resid = (asm.rhs_l - asm.W.T @ delta_p).reshape(L, lm)
    return torch.einsum("lij,lj->li", asm.vinv, resid).reshape(-1)


def calibration_marginals(asm: Assembly, calib_dim: int) -> torch.Tensor:
    """Marginal covariance (K, K) of the calibration block: the last K
    columns of S^-1, by a Cholesky factor and K unit-vector solves."""
    N = asm.S.shape[0]
    eye = torch.eye(N, dtype=asm.S.dtype, device=asm.S.device)
    c, _ = torch.linalg.cholesky_ex(asm.S + 1e-10 * eye)
    cols = torch.cholesky_solve(eye[:, N - calib_dim:], c)
    return cols[N - calib_dim:, :]


def dump_system(asm: Assembly, out_dir: str) -> None:
    """Write the reduced camera system as text files (`s.txt`, `rhs.txt`,
    `u.txt`, `rhs_p.txt`, `w.txt`, `v.txt`, `rhs_l.txt`), the reference's
    dump for cross-implementation comparison."""
    os.makedirs(out_dir, exist_ok=True)
    for name, arr in [("s", asm.S), ("rhs", asm.rhs_sc), ("u", asm.U),
                      ("rhs_p", asm.rhs_p), ("w", asm.W),
                      ("v", asm.V.reshape(asm.V.shape[0], -1)),
                      ("rhs_l", asm.rhs_l)]:
        np.savetxt(os.path.join(out_dir, f"{name}.txt"),
                   arr.detach().cpu().numpy())
