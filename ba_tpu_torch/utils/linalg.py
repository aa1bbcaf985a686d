"""Small batched linear-algebra helpers (port of `ba_tpu/utils/linalg.py`).

Closed-form 3x3 blocks keep the per-residual covariance factors elementwise
instead of many tiny batched LAPACK calls.
"""

from __future__ import annotations

import torch


def chol3(A):
    """Closed-form lower Cholesky of batched 3x3 SPD blocks.  Pivots are
    clamped at a tiny positive floor so exactly-PSD inputs (zero rows)
    yield a zero factor column instead of 0/0 NaNs."""
    tiny = 1e-30
    l11 = torch.sqrt(torch.clamp(A[..., 0, 0], min=0.0))
    d1 = torch.clamp(l11, min=tiny)
    l21 = A[..., 1, 0] / d1
    l31 = A[..., 2, 0] / d1
    l22 = torch.sqrt(torch.clamp(A[..., 1, 1] - l21 * l21, min=0.0))
    d2 = torch.clamp(l22, min=tiny)
    l32 = (A[..., 2, 1] - l31 * l21) / d2
    l33 = torch.sqrt(torch.clamp(A[..., 2, 2] - l31 * l31 - l32 * l32,
                                 min=0.0))
    z = torch.zeros_like(l11)
    return torch.stack([
        torch.stack([l11, z, z], dim=-1),
        torch.stack([l21, l22, z], dim=-1),
        torch.stack([l31, l32, l33], dim=-1)], dim=-2)


def tri_inv3(L):
    """Closed-form inverse of batched lower-triangular 3x3 blocks."""
    i11 = 1.0 / L[..., 0, 0]
    i22 = 1.0 / L[..., 1, 1]
    i33 = 1.0 / L[..., 2, 2]
    w21 = -L[..., 1, 0] * i11 * i22
    w32 = -L[..., 2, 1] * i22 * i33
    w31 = (L[..., 1, 0] * L[..., 2, 1]
           - L[..., 2, 0] * L[..., 1, 1]) * i11 * i22 * i33
    z = torch.zeros_like(i11)
    return torch.stack([
        torch.stack([i11, z, z], dim=-1),
        torch.stack([w21, i22, z], dim=-1),
        torch.stack([w31, w32, i33], dim=-1)], dim=-2)


def _blk(A, i, j):
    return A[..., 3 * i: 3 * i + 3, 3 * j: 3 * j + 3]


def _mT(M):
    return M.transpose(-1, -2)


def _from_blocks(blocks, n, like):
    z3 = torch.zeros_like(like)
    rows = [torch.cat([blocks[i][j] if j <= i else z3 for j in range(n)],
                      dim=-1) for i in range(n)]
    return torch.cat(rows, dim=-2)


def chol_blocked(A):
    """Lower Cholesky of batched (3n x 3n) SPD matrices by 3x3 blocks."""
    n = A.shape[-1] // 3
    L = [[None] * n for _ in range(n)]
    Rinv = [None] * n
    for i in range(n):
        for j in range(i + 1):
            S = _blk(A, i, j)
            for k in range(j):
                S = S - L[i][k] @ _mT(L[j][k])
            if i == j:
                L[i][i] = chol3(S)
                Rinv[i] = tri_inv3(L[i][i])
            else:
                L[i][j] = S @ _mT(Rinv[j])
    return _from_blocks(L, n, _blk(A, 0, 0))


def tri_inv_blocked(L):
    """Inverse of batched lower-triangular (3n x 3n) matrices by 3x3
    blocks (companion of `chol_blocked`)."""
    n = L.shape[-1] // 3
    W = [[None] * n for _ in range(n)]
    for i in range(n):
        W[i][i] = tri_inv3(_blk(L, i, i))
    for i in range(n):
        for j in range(i - 1, -1, -1):
            S = _blk(L, i, j) @ W[j][j]
            for k in range(j + 1, i):
                S = S + _blk(L, i, k) @ W[k][j]
            W[i][j] = -W[i][i] @ S
    return _from_blocks(W, n, _blk(L, 0, 0))


def whiten_factor(cov_inv_or_cov, from_cov=False):
    """A factor S with S^T S == cov_inv, batched (any square root whitens:
    the solver only sees quadratic forms).  `from_cov=True` takes the
    covariance C and returns S = chol(C)^-1 without forming the inverse."""
    if from_cov:
        return tri_inv_blocked(chol_blocked(cov_inv_or_cov))
    return _mT(chol_blocked(cov_inv_or_cov))


def inv3(A):
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / det
    rows = torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co10, co11, co12], dim=-1),
        torch.stack([co20, co21, co22], dim=-1),
    ], dim=-2)
    return rows * inv_det[..., None, None]


def block_diag_inv(V, floor=1e-6):
    """Invert a batch of small SPD blocks with a diagonal floor; closed
    forms for the 1x1 (inverse-depth) and 3x3 (XYZ landmark) cases, else
    `inv_ex`, which reports a singular block in its info instead of
    raising and so makes no host sync."""
    k = V.shape[-1]
    V = V + floor * torch.eye(k, dtype=V.dtype, device=V.device)
    if k == 1:
        return 1.0 / V
    if k == 3:
        return inv3(V)
    return torch.linalg.inv_ex(V)[0]
