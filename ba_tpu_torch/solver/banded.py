"""Banded direct solve of the Schur-reduced camera system.

Port of `ba_tpu/solver/banded.py`, the solvers for long trajectories.
Along a trajectory the reduced Hessian S = U - W V^-1 W^T is a block band:
two-pose residuals couple nearby poses, and the Schur correction couples
the poses that co-observe a landmark, a span bounded by `band_width_of`.

  1. U and the Schur correction land on a (P, B) block band grid
     (`band_S`).  The correction takes one of two forms: below
     `_GROUPED_SP_MIN` per-landmark block pairs, one -Wb_i V^-1 Wb_j^T row per
     pair of the host-enumerated pair table, summed onto the grid with the
     residual families; above it the grouped per-landmark form, which on
     the card is kernel 7 (kernels/csrc/band_schur.cu).
  2. `use_banded_solver`: the band is Jacobi-scaled and factorized as a
     chunked block-tridiagonal system (chunks of >= B poses), by batched
     block cyclic reduction (`_bcr_factor`) or a sequential scan
     (`_factor`), and used as the preconditioner of a short PCG whose
     products are kernel 9 (kernels/csrc/band_matvec.cu).  On the card the
     scaling and chunk layout, the factor and the solves are K8
     (kernels/chunk_tridiag.py: K8a, K8b, K8c), on the CPU their plain
     versions here (`jacobi_scaled`, `chunk_system`, `_bcr_factor`,
     `_factor`, `_bcr_solve`, `_solve_factored`).
     `schur_on_band`: the band is densified (K5b on the card), the
     marginalization prior added, and solved by one dense Cholesky
     (`banded_dense_solve`).
  3. Landmark back-substitution through the blocks (solver/cg.py).

A failed chunk factor is flagged on the device (K8b) or by `cholesky_ex`'s
info (the plain versions), with no host read, and together with non-finite
factors rejects the step (`ok == False`, a zero pose step), as the NaNs of
`jnp.linalg.cholesky` do in ba_tpu.  The dense Choleskys of
`schur_on_band` and of the fleet stay `torch.linalg` (cuSOLVER), which is
what the JAX package leaves to XLA.

Every segment sum goes through segsum on a `BandPlan` built once per
solve (`band_plan`): band_S is one launch of two groups (the 6x6 grid, with
the pair rows on the pair path, and the IMU grid).

A fused fleet of F equal windows (`core/problem.py:concat_problems`,
`config.fleet_size`) whose windows are small enough takes
`solve_reduced_fleet_dense`: each window's U densified off the
families-only band, its Schur complement by one batched product through
dense W operands, and one batched Cholesky.  Kernel 10
(kernels/csrc/fleet_schur.cu) writes the W operands from the build's W
blocks and, after the `torch.bmm`, forms the scaled system from the band
and the product in one pass; the Cholesky and the triangular solves stay
`torch.linalg`.  Its plan (`fleet_dense_plan`) holds the families-only
grid and kernel 10's block table.

Not ported: the sharded layout (`lm_offset`, queue 1, distribution) and
`_effective_pcg_iters`' TPU-only clamp: the PCG count is
`banded_pcg_iterations or 4`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..core.problem import BAConfig, Problem
from ..kernels import band_matvec as k9
from ..kernels import band_schur as k7
from ..kernels import chunk_tridiag as k8
from ..kernels import fleet_schur as k10
from ..kernels import segsum
from . import assemble as asm
from . import cg as cg_mod
from .assemble import _band_pair_blocks, _outer
from .linear import GnStep


# Switch the banded Schur correction from the per-pair rows to the grouped
# per-landmark form past this many pair-table rows (ba_tpu's threshold, kept
# so that both packages take the same path) ...
_GROUPED_SP_MIN = 200_000
# ... unless the plain grouped form would materialize more than this many
# bytes of per-landmark pair blocks (L * B^2 * 36 * itemsize)
_GROUPED_C_BYTES_MAX = 4_000_000_000


class BandPlan(NamedTuple):
    """band_S's segment plans and kernel 7's tables, built once per solve
    (`band_plan`)."""

    grouped: bool
    grid: segsum.SegPlan       # (P*B) 6x6 band grid of the families; on the
    #                            pair path followed by the Schur pair rows
    imu_grid: segsum.SegPlan   # (P*B) DxD band grid of the IMU family
    schur: Optional[k7.SchurPlan]   # kernel 7's tables (grouped path)


class FleetPlan(NamedTuple):
    """The plans of the dense fleet solve, built once per solve
    (`fleet_dense_plan`)."""

    grid: segsum.SegPlan       # (P*B) 6x6 band grid of the families only
    imu_grid: segsum.SegPlan   # (P*B) DxD band grid of the IMU family
    table: torch.Tensor        # kernel 10's W block table (`fleet_plan`)


def grouped_schur(problem: Problem, config: BAConfig) -> bool:
    """Whether band_S takes the grouped Schur form (ba_tpu's gate)."""
    L = problem.lms.x.shape[0]
    B = config.band_width
    return (problem.pidx.sp_i.shape[0] >= _GROUPED_SP_MIN
            and L * B * B * 36 * problem.poses.t.element_size()
            <= _GROUPED_C_BYTES_MAX)


def band_plan(problem: Problem, config: BAConfig, ids=None,
              grouped: Optional[bool] = None) -> BandPlan:
    """The plans of band_S for `problem` (0 < band_width <= P), on its
    device, with no host read.  `ids` is `assemble.sum_ids` of the problem
    when the caller has it; `grouped` defaults to `grouped_schur`."""
    P, L = problem.poses.q.shape[0], problem.lms.x.shape[0]
    B = config.band_width
    if ids is None:
        ids = asm.sum_ids(problem, config)
    if grouped is None:
        grouped = grouped_schur(problem, config)
    idx = problem.pidx
    grid_ids, nseg = ids["grid"]
    schur = None
    if grouped:
        schur = k7.schur_plan(idx.wb_pose, idx.wb_lm, P, L, B)
    else:
        grid_ids = torch.cat([grid_ids, _pair_seg(idx, P, B)])
    return BandPlan(grouped, segsum.build_plan(grid_ids, nseg),
                    segsum.build_plan(*ids["imu_grid"]), schur)


def fleet_dense_plan(problem: Problem, config: BAConfig,
                     ids=None) -> FleetPlan:
    """The plans of `solve_reduced_fleet_dense` for a fused fleet of
    `config.fleet_size` windows: the band grid of the residual families
    only (no Schur rows) and kernel 10's W block table, on the problem's
    device, with no host read."""
    P, L = problem.poses.q.shape[0], problem.lms.x.shape[0]
    if ids is None:
        ids = asm.sum_ids(problem, config)
    idx = problem.pidx
    return FleetPlan(segsum.build_plan(*ids["grid"]),
                     segsum.build_plan(*ids["imu_grid"]),
                     k10.fleet_plan(idx.wb_pose, idx.wb_lm, P, L,
                                    config.fleet_size))


def _pair_seg(idx, P: int, B: int):
    """Band-grid ids of the Schur pair rows: pair (i, j) at a = pose_i,
    d = pose_j - a; padding pairs and pairs past the band are dropped."""
    a = idx.wb_pose.long()[idx.sp_i.long()]
    d = idx.wb_pose.long()[idx.sp_j.long()] - a
    return torch.where(idx.sp_valid & (d < B), a * B + d, P * B)


def _band_self_cross(bs: cg_mod.BlockSystem, P: int, B: int, D: int,
                     plan, extra6=None):
    """U on the (P, B) band grid from the weighted family blocks (band[p, d]
    = U[p, p+d] block, d >= 0), one launch on the `grid` and `imu_grid` of
    `plan` (a BandPlan or FleetPlan); `extra6` are further (n, 6, 6) rows
    that `plan.grid` sums with the 6x6 families (the pair path's Schur
    rows)."""
    pb = bs.pj
    rows = [_outer(pb.j_m, pb.j_m), _outer(pb.j_r, pb.j_r),
            _outer(bs.ju, bs.ju), _outer(bs.jb1, bs.jb1),
            _outer(bs.jb2, bs.jb2),
            _band_pair_blocks(pb.j_m, pb.j_r, pb.pose, pb.ref),
            _band_pair_blocks(bs.jb1, bs.jb2, bs.b1, bs.b2)]
    if extra6 is not None:
        rows.append(extra6)
    groups = [(torch.cat(rows), plan.grid)]
    if bs.ji1 is not None:
        groups.append((torch.cat([
            _outer(bs.ji1, bs.ji1), _outer(bs.ji2, bs.ji2),
            _band_pair_blocks(bs.ji1, bs.ji2, bs.i1, bs.i2)]),
            plan.imu_grid))
    sums = asm.seg_sum_groups(groups)
    grid = F.pad(sums[0], (0, D - 6, 0, D - 6))
    if bs.ji1 is not None:
        grid = grid + sums[1]
    return grid


def band_schur_plain(wb_pose, wb_lm, Wb, vinv, P: int, B: int):
    """The plain version of kernel 7, ba_tpu's grouped formulation: every
    landmark's W blocks on a local (B, 6, lm) strip anchored at its first
    observing pose, all pair products as one (L, B, B, 6, 6) einsum, summed
    per anchor and folded onto the band by B shifted adds.  Returns corr
    (P, B, 6, 6), corr[a, d] = sum_l Wb_{a,l} V_l^-1 Wb_{a+d,l}^T."""
    L, lm, _ = vinv.shape
    i_loc, kept = k7.slot_of(wb_pose, wb_lm, L, B)
    seg = torch.where(kept, wb_lm.long() * B + i_loc.clamp(0, B - 1), L * B)
    Wl = asm._seg_sum_plain(Wb.reshape(Wb.shape[0], -1), seg, L * B)
    Wl = Wl.reshape(L, B, 6, lm)
    WlVi = torch.einsum("lbik,lkm->lbim", Wl, vinv)
    C = torch.einsum("lbim,lcjm->lbcij", WlVi, Wl)        # (L, B, B, 6, 6)
    first = k7.first_pose(wb_pose, wb_lm, L).clamp(0, P - 1)
    G = Wl.new_zeros((P, B * B * 36)).index_add_(0, first,
                                                 C.reshape(L, -1))
    G = G.reshape(P, B, B, 6, 6)
    # corr[a, d] = sum_i G[a - i, i, i + d]  (upper triangle j = i + d)
    corr = Wl.new_zeros((P, B, 6, 6))
    for i in range(min(B, P)):
        corr[i:, : B - i] += G[: P - i, i, i:]
    return corr


def _band_schur_grouped(idx, Wb, vinv, P: int, B: int,
                        plan: Optional[k7.SchurPlan] = None):
    """Banded Schur correction without the per-pair table: every
    landmark's observing poses span < B (the band contract), so its W blocks
    fit a local strip of B slots anchored at its first observing pose.
    Returns corr (P, B, 6, 6), corr[a, d] = sum over landmarks of
    Wb_{a,l} V_l^-1 Wb_{a+d,l}^T (the quantity band_S subtracts).

    CUDA tensors go through kernel 7 on `plan` (built here when absent),
    CPU tensors through `band_schur_plain`.

    As in ba_tpu (ADVICE r5, `ba_tpu/solver/banded.py:116`): a W block whose
    slot i_loc falls at or past B is dropped as a whole row here, with all
    its pairs, where the pair path drops only the single pairs that reach
    past the band.  With `band_width = band_width_of(problem)` no block
    does."""
    if Wb.is_cuda:
        if plan is None:
            plan = k7.schur_plan(idx.wb_pose, idx.wb_lm, P, vinv.shape[0], B)
        return k7.band_schur(Wb, vinv, plan, P)
    return band_schur_plain(idx.wb_pose, idx.wb_lm, Wb, vinv, P, B)


def band_S(problem: Problem, config: BAConfig, bs: cg_mod.BlockSystem,
           P: int, D: int, add_identity: bool = True,
           plan: Optional[BandPlan] = None):
    """Schur-reduced band (P, B, D, D): band[p, d] = S[p, p+d] (d >= 0,
    diagonal blocks full/symmetric), with masked dims as identity rows.

    `config.band_width` must come from `band_width_of`, which bounds both
    residual spans and landmark co-observation spans: out-of-band
    contributions break the indexing contract and are not clipped.

    `plan` defaults to the block system's band plan; a plan built for the
    other Schur form is rebuilt (the form is chosen here, at call time, from
    `_GROUPED_SP_MIN`)."""
    B = config.band_width
    dtype = bs.rhs_sc.dtype
    grouped = grouped_schur(problem, config)
    if plan is None:
        plan = bs.plan.band
    if plan is None or plan.grouped != grouped:
        plan = band_plan(problem, config, grouped=grouped)
    idx = problem.pidx
    Wb = bs.wb
    pd = (torch.arange(P, device=Wb.device)[:, None]
          + torch.arange(B, device=Wb.device)[None, :])
    if grouped:
        corr = _band_schur_grouped(idx, Wb, bs.vinv, P, B, plan.schur)
        band = _band_self_cross(bs, P, B, D, plan).reshape(P, B, D, D)
        band = band - F.pad(corr, (0, D - 6, 0, D - 6))
    else:
        # Schur correction: for each per-landmark W-block pair (i, j) with
        # a = pose_i <= b = pose_j, subtract Wb_i V^-1 Wb_j^T at band
        # segment (a, b - a), summed with the residual families
        L = bs.vinv.shape[0]
        WbVi = torch.einsum("nkl,nlm->nkm", Wb,
                            bs.vinv[idx.wb_lm.long().clamp(0, L - 1)])
        corr = torch.einsum("nkl,nql->nkq", WbVi[idx.sp_i.long()],
                            Wb[idx.sp_j.long()])
        corr = corr * idx.sp_valid[:, None, None].to(dtype)
        band = _band_self_cross(bs, P, B, D, plan, extra6=-corr)
        band = band.reshape(P, B, D, D)
    # zero blocks that would wrap past the last pose
    band = band * (pd < P)[:, :, None, None].to(dtype)
    if add_identity:
        band = band_add_identity(band, bs.col_mask, P, D)
    return band


def band_add_identity(band, col_mask, P, D):
    """Masked dims -> identity rows/cols (Jacobian columns are already
    zeroed; the dense path's 1e6 diagonal collapses to identity in the
    masked subspace)."""
    mD = col_mask[: P * D].reshape(P, D).to(band.dtype)
    eye = torch.eye(D, dtype=band.dtype, device=band.device)
    ident = eye[None] * (1.0 - mD)[:, :, None]             # (P, D, D)
    return torch.cat([band[:, :1] + ident[:, None], band[:, 1:]], dim=1)


def band_matvec_plain(band, x):
    """The plain version of kernel 9 (ba_tpu's formulation): y = S x for
    the symmetric band representation; x (P*D,)."""
    P, B, D, _ = band.shape
    dev = band.device
    X = x.reshape(P, D)
    up = torch.arange(P, device=dev)[:, None] + torch.arange(
        B, device=dev)[None, :]
    Xu = X[up.clamp(max=P - 1)] * (up < P)[:, :, None].to(x.dtype)
    y = torch.einsum("pbij,pbj->pi", band, Xu)
    # strictly-lower part: y_q += band[q-d, d]^T x_{q-d}, d >= 1
    lo = torch.arange(P, device=dev)[:, None] - torch.arange(
        1, B, device=dev)[None, :]
    lo_c = lo.clamp(0, P - 1)
    bg = band[lo_c, torch.arange(1, B, device=dev)[None, :]]
    Xl = X[lo_c] * (lo >= 0)[:, :, None].to(x.dtype)
    y = y + torch.einsum("pbij,pbi->pj", bg, Xl)
    return y.reshape(-1)


def band_matvec(band, x):
    """y = S x for the symmetric band representation; x (P*D,).  CUDA
    tensors go through kernel 9, CPU tensors through `band_matvec_plain`."""
    if band.is_cuda:
        return k9.band_matvec(band, x)
    return band_matvec_plain(band, x)


def _chunk_windows(band, chunk):
    """(..., n_c, chunk*D, chunk*D) diagonal chunk blocks and the
    (..., n_c, chunk*D, chunk*D) coupling to the next chunk of a band
    (..., P, B, D, D), P a multiple of `chunk` >= B - 1: each chunk's rows
    are laid out over this chunk and the next by the scatter-free
    pad/flatten placement of `assemble.band_to_dense`."""
    *lead, P, B, D, _ = band.shape
    n_c = P // chunk
    n = chunk * D
    W2 = 2 * n

    def window(ch):             # (..., chunk, Bb, D, D) -> (..., n, W2)
        Bb = ch.shape[-3]
        out = ch.shape[:-4]
        R = ch.transpose(-3, -2).reshape(*out, chunk, D, Bb * D)
        R = F.pad(R, (0, W2 - Bb * D))
        R = F.pad(R.reshape(*out, chunk, D * W2), (0, D))
        return R.reshape(*out, -1)[..., : n * W2].reshape(*out, n, W2)

    chunks = band.reshape(*lead, n_c, chunk, B, D, D)
    win = window(chunks)                                  # (..., n_c, n, W2)
    diag_once = window(chunks[..., :1, :, :])[..., :n]
    upper = win[..., :n]
    Dg = upper + upper.transpose(-1, -2) - diag_once      # (..., n_c, n, n)
    Eg = win[..., n:]                                     # coupling to next
    return Dg, Eg


def _chol(A):
    """Lower Cholesky factor and its success flag (info == 0, finite), with
    no host read."""
    c, info = torch.linalg.cholesky_ex(A)
    return c, torch.all(info == 0) & torch.all(torch.isfinite(c))


def _factor(Dg, Eg):
    """Block-tridiagonal Cholesky: S = L L^T with L block lower-bidiagonal
    (diag C_i, subdiag M_i), a scan over the chunks (batched over leading
    dims).  Returns (C, M, ok)."""
    m, n = Dg.shape[-3], Dg.shape[-1]
    C_prev = torch.eye(n, dtype=Dg.dtype, device=Dg.device).expand(
        Dg.shape[:-3] + (n, n))
    E_prev = torch.zeros_like(C_prev)
    Cs, Ms = [], []
    ok = torch.ones((), dtype=torch.bool, device=Dg.device)
    for i in range(m):
        X = torch.linalg.solve_triangular(C_prev, E_prev, upper=False)
        C_i, ok_i = _chol(Dg[..., i, :, :] - X.mT @ X)
        ok = ok & ok_i
        Cs.append(C_i)
        Ms.append(X.mT)
        C_prev, E_prev = C_i, Eg[..., i, :, :]
    return torch.stack(Cs, dim=-3), torch.stack(Ms, dim=-3), ok


def _cho_solve_b(c, b):
    """Batched SPD solve from batched lower-Cholesky factors c (..., n, n)
    against b (..., n) or (..., n, k)."""
    vec = b.dim() == c.dim() - 1
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(c, b, upper=False)
    x = torch.linalg.solve_triangular(c.mT, y, upper=True)
    return x[..., 0] if vec else x


def _bcr_factor(Dg, Eg):
    """Block cyclic reduction of the SPD block-tridiagonal chunk system
    (batched over leading dims): each level eliminates the odd chunks at
    once, halving the system, log2(n_c) levels in all.  For the system
    E_{i-1}^T x_{i-1} + D_i x_i + E_i x_{i+1} = b_i, per level, for the kept
    (even) blocks
        D'_k = D_2k - B_{k-1}^T Dodd_{k-1}^{-1} B_{k-1} - A_k Dodd_k^{-1} A_k^T
        E'_k = -A_k Dodd_k^{-1} B_k
    with A_k = E_{2k}, B_k = E_{2k+1}, Dodd_k = D_{2k+1}; the chunk count is
    padded to a power of two with identity blocks.

    Returns (levels, ok): levels = [(chol(Dodd), A, B), ...] outer to inner,
    then the base-case Cholesky."""
    m, n = Dg.shape[-3], Dg.shape[-1]
    M2 = 1 << max(m - 1, 0).bit_length()          # next power of two
    if M2 > m:
        pad = M2 - m
        eye = torch.eye(n, dtype=Dg.dtype, device=Dg.device)
        Dg = torch.cat([Dg, eye.expand(Dg.shape[:-3] + (pad, n, n))], dim=-3)
        Eg = torch.cat([Eg, Eg.new_zeros(Eg.shape[:-3] + (pad, n, n))],
                       dim=-3)
        m = M2
    levels = []
    ok = torch.ones((), dtype=torch.bool, device=Dg.device)
    D, E = Dg, Eg
    while m > 1:
        A = E[..., 0::2, :, :]                     # E_{2k}
        Bo = E[..., 1::2, :, :]                    # E_{2k+1}
        c, ok_l = _chol(D[..., 1::2, :, :])
        ok = ok & ok_l
        X = _cho_solve_b(c, A.mT)                  # Dodd^{-1} A^T
        Z = _cho_solve_b(c, Bo)                    # Dodd^{-1} B
        T1 = Bo.mT @ Z
        T1 = torch.cat([torch.zeros_like(T1[..., :1, :, :]),
                        T1[..., :-1, :, :]], dim=-3)
        T2 = A @ X
        levels.append((c, A, Bo))
        D = D[..., 0::2, :, :] - T1 - T2
        E = -(A @ Z)
        m //= 2                                    # ends with E[m-1] = 0
    c0, ok_0 = _chol(D[..., 0, :, :])
    levels.append(c0)
    return levels, ok & ok_0


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _bcr_solve(levels, b, m_orig):
    """x = S^-1 b through the cyclic-reduction levels; b (..., m_orig, n)
    -> (..., m_orig * n)."""
    n = b.shape[-1]
    lead = b.shape[:-2]
    m_pad = 2 ** (len(levels) - 1)
    if m_pad > m_orig:
        b = torch.cat([b, b.new_zeros(lead + (m_pad - m_orig, n))], dim=-2)

    def rec(li, b):
        if li == len(levels) - 1:
            return _cho_solve_b(levels[li], b[..., 0, :])[..., None, :]
        c, A, Bo = levels[li]
        b_odd, b_even = b[..., 1::2, :], b[..., 0::2, :]
        u = _cho_solve_b(c, b_odd)
        t1 = _mv(Bo.mT, u)                                   # -> even k+1
        t1 = torch.cat([torch.zeros_like(t1[..., :1, :]), t1[..., :-1, :]],
                       dim=-2)
        t2 = _mv(A, u)                                       # -> even k
        x_even = rec(li + 1, b_even - t1 - t2)
        x_right = torch.cat([x_even[..., 1:, :],
                             torch.zeros_like(x_even[..., :1, :])], dim=-2)
        rhs_odd = b_odd - _mv(A.mT, x_even) - _mv(Bo, x_right)
        x_odd = _cho_solve_b(c, rhs_odd)
        return torch.stack([x_even, x_odd], dim=-2).reshape(
            *lead, -1, n)

    return rec(0, b)[..., :m_orig, :].reshape(*lead, -1)


def _solve_factored(C, M, b):
    """x = (L L^T)^-1 b given the chunked factors; b (..., n_c, n) ->
    (..., n_c * n)."""
    m = C.shape[-3]
    lead = b.shape[:-2]
    y_prev = torch.zeros_like(b[..., 0, :])
    Y = []
    for i in range(m):
        y_i = torch.linalg.solve_triangular(
            C[..., i, :, :], (b[..., i, :] - _mv(M[..., i, :, :], y_prev))[
                ..., None], upper=False)[..., 0]
        Y.append(y_i)
        y_prev = y_i
    x_next = torch.zeros_like(y_prev)
    X = [None] * m
    for i in reversed(range(m)):
        rhs = Y[i]
        if i + 1 < m:
            rhs = rhs - _mv(M[..., i + 1, :, :].mT, x_next)
        x_next = torch.linalg.solve_triangular(
            C[..., i, :, :].mT, rhs[..., None], upper=True)[..., 0]
        X[i] = x_next
    return torch.stack(X, dim=-2).reshape(*lead, -1)


def solve_reduced_banded_dense(problem: Problem, config: BAConfig,
                               bs: cg_mod.BlockSystem, P: int, D: int,
                               marg_H=None) -> GnStep:
    """Banded S assembly + dense Jacobi-scaled Cholesky + landmark
    back-substitution through the blocks (`schur_on_band`): the Schur
    correction never forms the dense W V^-1 W^T product, the factorization
    stays one exact dense Cholesky, and the marginalization prior joins at
    the dense stage."""
    band = band_S(problem, config, bs, P, D)
    delta_p, ok = banded_dense_solve(band, bs.rhs_sc, bs.col_mask, marg_H)
    delta_l = cg_mod.back_substitute_blocks(bs, delta_p, P, D, 0)
    return GnStep(delta_p=delta_p, delta_l=delta_l, ok=ok)


def fleet_band(bs: cg_mod.BlockSystem, config: BAConfig, P: int, D: int,
               plan: FleetPlan):
    """U of a fused fleet on the (P, B, D, D) band grid, from the residual
    families only (one kernel-2 launch on `plan.grid`), masked dims as
    identity rows: the band kernel 10 (b) densifies per window."""
    B = config.band_width
    band = _band_self_cross(bs, P, B, D, plan).reshape(P, B, D, D)
    pd = (torch.arange(P, device=band.device)[:, None]
          + torch.arange(B, device=band.device)[None, :])
    band = band * (pd < P)[:, :, None, None].to(band.dtype)
    return band_add_identity(band, bs.col_mask, P, D)


def solve_reduced_fleet_dense(problem: Problem, config: BAConfig,
                              bs: cg_mod.BlockSystem, P: int,
                              D: int) -> GnStep:
    """Fleet reduced solve: per-window dense Schur complement and one
    batched Cholesky, (F, n_w, n_w) with n_w = (P/F) D, for a fused fleet
    of F equal windows (which never couple).

      * U comes off the families-only band grid, masked dims as identity
        rows, and is densified window by window inside kernel 10 (b);
      * the Schur correction is one batched product
        C = (V^-1 W)_T^T W_T over each window's dense (L_w lm, n_w)
        operands, which kernel 10 (a) writes from the build's W blocks;
      * kernel 10 (b) forms S = U_f - C, its Jacobi scaling and the eps
        damping; one batched `cholesky_ex`, two triangular solves and one
        refinement step, as `linear.solve_reduced` per window.

    `ok` is the factorization's info and finiteness, with no host read; a
    failed factor gives a zero pose step."""
    dtype = bs.rhs_sc.dtype
    F_ = config.fleet_size
    n_w = (P // F_) * D
    plan = bs.plan.fleet
    if plan is None:
        plan = fleet_dense_plan(problem, config)
    band = fleet_band(bs, config, P, D, plan)
    eps = 1e-8 if dtype == torch.float64 else 1e-4
    idx = problem.pidx
    if band.is_cuda:
        W_T, WVi_T = k10.fleet_w(bs.wb, bs.vinv, plan.table, F_, D)
        C = torch.bmm(WVi_T.mT, W_T)
        Ss, scal = k10.fleet_epilogue(band, C, F_, eps)
    else:
        W_T, WVi_T = k10.fleet_w_plain(bs.wb, bs.vinv, idx.wb_pose,
                                       idx.wb_lm, F_, P, D)
        C = torch.bmm(WVi_T.mT, W_T)
        Ss, scal = k10.fleet_epilogue_plain(band, C, F_, eps)
    c, ok = _chol(Ss)
    rhsF = (bs.rhs_sc * scal.reshape(-1)).reshape(F_, n_w)
    x = _cho_solve_b(c, rhsF)
    # one step of iterative refinement in the scaled space
    x = x + _cho_solve_b(c, rhsF - _mv(Ss, x))
    delta_p = x.reshape(-1) * scal.reshape(-1)
    delta_p = torch.where(torch.isfinite(delta_p) & ok, delta_p, 0.0)
    delta_p = torch.where(bs.col_mask, delta_p, 0.0)
    delta_l = cg_mod.back_substitute_blocks(bs, delta_p, P, D, 0)
    return GnStep(delta_p=delta_p, delta_l=delta_l, ok=ok)


def banded_dense_solve(band, rhs_sc, col_mask, marg_H=None):
    """Densify an assembled band, optionally add the dense marginalization
    prior curvature, and solve by Jacobi-scaled Cholesky + one refinement
    step (`linear.solve_reduced`'s numerics).  Returns (delta_p, ok)."""
    dtype = rhs_sc.dtype
    S = band_to_dense_sym(band)
    if marg_H is not None:
        S = S + marg_H
    scal = torch.rsqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    Ss = S * scal[:, None] * scal[None, :]
    eps = 1e-8 if dtype == torch.float64 else 1e-4
    Ss = Ss + eps * torch.eye(S.shape[0], dtype=dtype, device=S.device)
    c, info = torch.linalg.cholesky_ex(Ss)
    ok = (info == 0) & torch.all(torch.isfinite(torch.diagonal(c)))

    def scaled_solve(rhs):
        return torch.cholesky_solve((rhs * scal)[:, None], c)[:, 0] * scal

    delta_p = scaled_solve(rhs_sc)
    delta_p = delta_p + scaled_solve(rhs_sc - S @ delta_p)
    delta_p = torch.where(torch.isfinite(delta_p) & ok, delta_p, 0.0)
    return torch.where(col_mask, delta_p, 0.0), ok


def band_to_dense_sym(band):
    """(P, B, D, D) band -> dense symmetric (P*D, P*D)."""
    return asm.band_to_dense(band)


def solve_reduced_banded(problem: Problem, config: BAConfig,
                         bs: cg_mod.BlockSystem, P: int, D: int) -> GnStep:
    """Banded S assembly + chunked block-tridiagonal factorization (batched
    cyclic reduction by default, the sequential scan otherwise) as the
    preconditioner of a short PCG + landmark back-substitution through the
    blocks.  Same Jacobi scaling and relative eps damping as
    `linear.solve_reduced`."""
    band = band_S(problem, config, bs, P, D)
    delta_p, ok = banded_pcg_solve(band, bs.rhs_sc, bs.col_mask, config,
                                   P, D)
    delta_l = cg_mod.back_substitute_blocks(bs, delta_p, P, D, 0)
    return GnStep(delta_p=delta_p, delta_l=delta_l, ok=ok)


def jacobi_scaled(band):
    """(band_s, scal): the band of the system the PCG solves, Jacobi-scaled
    in band form, band_s[p,d,i,j] = s[p,i] band[p,d,i,j] s[p+d,j] with
    s = diag^-1/2, plus eps on the diagonal (1e-8 in f64, 1e-4 in f32: a
    relative damping, as in `linear.solve_reduced`).  Plain version of
    K8a's band_s and scal."""
    P, B, D, _ = band.shape
    dev = band.device
    diag = torch.diagonal(band[:, 0], dim1=-2, dim2=-1)        # (P, D)
    scal = torch.rsqrt(torch.clamp(diag, min=1e-12))
    up = (torch.arange(P, device=dev)[:, None]
          + torch.arange(B, device=dev)[None, :]).clamp(max=P - 1)
    band_s = band * scal[:, None, :, None] * scal[up][:, :, None, :]
    eps = _eps(band.dtype)
    eye = torch.eye(D, dtype=band.dtype, device=dev)
    band_s = torch.cat([band_s[:, :1] + eps * eye, band_s[:, 1:]], dim=1)
    return band_s, scal


def _eps(dtype):
    return 1e-8 if dtype == torch.float64 else 1e-4


def chunk_geometry(config: BAConfig, P: int, B: int):
    """(F, P_w, chunk, n_c): F = `config.fleet_size` windows when F > 1
    divides P, else one; n_c chunks of `chunk` >= B poses per window of P_w
    poses."""
    F_ = config.fleet_size if (config.fleet_size > 1
                               and P % config.fleet_size == 0) else 1
    P_w = P // F_
    # chunk size >= B makes the system block-tridiagonal in chunks
    chunk = max(B, min(P_w, config.banded_chunk or 16))
    return F_, P_w, chunk, -(-P_w // chunk)


def chunk_system(band_s, config: BAConfig, P: int, D: int):
    """(Dg, Eg, F, P_w, chunk, n_c): the chunked block-tridiagonal system
    of a scaled band (`_chunk_windows`), per window (`chunk_geometry`),
    each window padded with identity diagonal blocks to n_c * chunk poses.
    Plain version of K8a's Dg and Eg."""
    B = band_s.shape[1]
    F_, P_w, chunk, n_c = chunk_geometry(config, P, B)
    Pp_w = n_c * chunk
    bandF = band_s.reshape(F_, P_w, B, D, D)
    if Pp_w > P_w:
        pad = band_s.new_zeros((F_, Pp_w - P_w, B, D, D))
        pad[:, :, 0] = torch.eye(D, dtype=band_s.dtype, device=band_s.device)
        bandF = torch.cat([bandF, pad], dim=1)
    Dg, Eg = _chunk_windows(bandF, chunk)
    return Dg, Eg, F_, P_w, chunk, n_c


def chunk_layout(band, config: BAConfig, P: int, D: int, use_bcr: bool):
    """(band_s, scal, Dg, Eg): the scaled band and its chunk blocks.  CUDA
    tensors go through K8a in one launch, Dg and Eg already padded to a
    power-of-two chunk count under cyclic reduction; CPU tensors through
    `jacobi_scaled` and `chunk_system`."""
    if band.is_cuda:
        F_, _, chunk, n_c = chunk_geometry(config, P, band.shape[1])
        m = k8.next_pow2(n_c) if use_bcr else n_c
        return k8.chunk_layout(band, F_, chunk, m, _eps(band.dtype))
    band_s, scal = jacobi_scaled(band)
    Dg, Eg = chunk_system(band_s, config, P, D)[:2]
    return band_s, scal, Dg, Eg


def chunk_factor(Dg, Eg, use_bcr: bool):
    """(factor, ok): cyclic reduction's levels or the scan's (C, M).  CUDA
    tensors go through K8b, CPU tensors through `_bcr_factor` or
    `_factor`."""
    if use_bcr:
        return (k8.bcr_factor if Dg.is_cuda else _bcr_factor)(Dg, Eg)
    C, M, ok = (k8.scan_factor if Dg.is_cuda else _factor)(Dg, Eg)
    return (C, M), ok


def chunk_solve(factor, r, use_bcr: bool, n_c: int, chunk_dim: int):
    """z (F, L) = S^-1 r for r (F, L), L <= n_c * chunk_dim, each window's
    elements past L taken as zero.  CUDA tensors go through K8c (no pad, no
    cut), CPU tensors through `_bcr_solve` or `_solve_factored`."""
    if r.is_cuda:
        if use_bcr:
            return k8.bcr_solve(factor, r)
        return k8.scan_solve(*factor, r)
    L = r.shape[1]
    rF = F.pad(r, (0, n_c * chunk_dim - L)).reshape(r.shape[0], n_c,
                                                    chunk_dim)
    if use_bcr:
        z = _bcr_solve(factor, rF, n_c)
    else:
        z = _solve_factored(*factor, rF)
    return z[:, :L]


def banded_pcg_solve(band, rhs_sc, col_mask, config: BAConfig, P: int,
                     D: int):
    """Factor + solve the assembled band: Jacobi scaling, chunked
    block-tridiagonal Cholesky (or batched block cyclic reduction), short
    PCG.  With `config.fleet_size` F > 1 dividing P the band holds F
    independent windows, factorized as a leading batch dimension.  Returns
    (delta_p, ok).  On the card the layout, the factor and the solves are
    K8 (kernels/chunk_tridiag.py), the products kernel 9: no `torch.linalg`
    call and no host read.

    The chunked factorization is exact in exact arithmetic, but in f32 the
    sequential chunk Schur complements lose digits, so the factor is the
    preconditioner of `banded_pcg_iterations or 4` PCG iterations; past a
    relative residual of 1e-6 (f64) or 1e-5 (f32) further iterations are
    masked no-ops, with no host read.  `ok` also requires the residual not
    to exceed the rhs."""
    dtype = rhs_sc.dtype
    F_, P_w, chunk, n_c = chunk_geometry(config, P, band.shape[1])
    # log-depth batched cyclic reduction when the chunk chain is deep
    # enough; the 2-chunk system has nothing to gain
    use_bcr = config.banded_cyclic_reduction and n_c >= 4
    band_s, scal, Dg, Eg = chunk_layout(band, config, P, D, use_bcr)
    factor, ok = chunk_factor(Dg, Eg, use_bcr)
    del Dg, Eg

    def precond(r):
        return chunk_solve(factor, r.reshape(F_, P_w * D), use_bcr, n_c,
                           chunk * D).reshape(-1)

    b = rhs_sc * scal.reshape(-1)
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = r @ z
    n_pcg = config.banded_pcg_iterations or 4
    rel_tol2 = 1e-12 if dtype == torch.float64 else 1e-10
    b2 = b @ b
    for _ in range(n_pcg):
        live = r @ r > rel_tol2 * b2
        Ap = band_matvec(band_s, p)
        pAp = p @ Ap
        alpha = torch.where(live & (pAp > 0),
                            rz / torch.where(pAp > 0, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = r @ z
        beta = torch.where(live & (rz > 0),
                           rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        p = torch.where(live, z + beta * p, p)
        rz = torch.where(live, rz_new, rz)
    delta_p = x[: P * D] * scal.reshape(-1)
    # a failed factor gives finite garbage here where ba_tpu's NaN factor
    # gives NaNs: both end as a zero pose step
    delta_p = torch.where(torch.isfinite(delta_p) & ok, delta_p, 0.0)
    # reject steps the short PCG failed to stabilize
    ok = ok & (r @ r <= b @ b)
    return torch.where(col_mask, delta_p, 0.0), ok
