"""Kernel 10 (kernels/csrc/fleet_schur.cu): its plain version against
ba_tpu, and its windowed tile walk written in torch, on the CPU in f64.

  * `fleet_schur_plain` (the dense per-window operands, one batched
    product, the scaled epilogue) gives the (Ss, scal) that ba_tpu's
    `solve_reduced_fleet_dense` factors, on a fused fleet of two 12-pose
    windows, to 1e-12.
  * The kernel's schedule: a bitmask over each window's landmarks per 32
    rows (from the `fleet_plan` table: a pose's rows c < 6 with a W block),
    each row's diagonal summed over its own landmarks in ascending order,
    and each 64 x 64 lower tile walking the landmarks both its masks share,
    in ascending order, with W read through the table and U from the band.
    It equals `fleet_schur_plain` to 1e-12 at lm 1 and 3, F = 1, 2 and 4,
    with padding W blocks, masked dims, and tile pairs that share no
    landmark; the tile walk's S_ii equals the diagonal pass's d_i bit for
    bit, and Ss is exactly symmetric.
"""

import jax
import numpy as np
import pytest
import torch

from ba_tpu.core.residuals import imu as jimu
from ba_tpu.solver import banded as jbanded
from ba_tpu.solver import cg as jcg
from ba_tpu_torch.kernels import fleet_schur as k10
from ba_tpu_torch.solver import banded, cg, step
from ba_tpu_torch.solver.assemble import band_to_dense_plain

from chip_smoke import fleet_inputs
from test_torch_common import assert_rel
from test_torch_fleet import fleet_case

TOL = 1e-12


def test_fleet_schur_plain_matches_ba_tpu_operands(monkeypatch):
    jp, jcfg, tp, tcfg = fleet_case("equal")
    P, D, F = tp.poses.q.shape[0], tcfg.pose_dim, tcfg.fleet_size
    assert step._reduced_path(tp, tcfg)[0] == "fleet_dense"
    # ba_tpu's Ss and scal, as its solve hands them to the Cholesky
    jbs, _ = jcg.assemble_blocks(jp, jcfg, jimu.evaluate(jp, jcfg, True),
                                 with_precond=False)
    seen = {}
    chol, rsqrt = jax.numpy.linalg.cholesky, jax.lax.rsqrt

    def chol_rec(a, *args, **kw):
        seen["Ss"] = np.asarray(a)
        return chol(a, *args, **kw)

    def rsqrt_rec(a):
        seen["scal"] = np.asarray(rsqrt(a))
        return rsqrt(a)

    monkeypatch.setattr(jax.numpy.linalg, "cholesky", chol_rec)
    monkeypatch.setattr(jax.lax, "rsqrt", rsqrt_rec)
    jbanded.solve_reduced_fleet_dense(jp, jcfg, jbs, P, D)
    monkeypatch.undo()

    plan = step.solve_plan(tp, tcfg)
    bs, _ = cg.assemble_blocks(tp, tcfg, step._imu_eval(tp, tcfg, True, True),
                               with_precond=False, plan=plan)
    band = banded.fleet_band(bs, tcfg, P, D, plan.fleet)
    idx = tp.pidx
    Ss, scal = k10.fleet_schur_plain(bs.wb, bs.vinv, idx.wb_pose, idx.wb_lm,
                                     band, F, 1e-8)
    assert_rel(Ss, seen["Ss"], TOL, "Ss")
    assert_rel(scal, seen["scal"], TOL, "scal")


# ---------------------------------------------------------------------------
# The windowed tile walk


def tile_walk(wb, vinv, table, band, F, eps, tile=64, rng_=32):
    """(Ss, scal, tile pairs with no common landmark, diagonal d) as the
    kernel computes them: the masks from the table, each row's diagonal
    over its own landmarks, each lower tile over the landmarks both its
    masks share, ascending, one column (l, b) at a time."""
    P, B, D, _ = band.shape
    L, lm, _ = vinv.shape
    P_w, L_w, n_w = P // F, L // F, (P // F) * D
    nR = -(-n_w // rng_)
    rows = torch.arange(n_w)
    pose_of, dim_of = rows // D, rows % D
    Ss = torch.empty((F, n_w, n_w), dtype=band.dtype)
    scal = torch.empty((F, n_w), dtype=band.dtype)
    d = torch.empty((F, n_w), dtype=band.dtype)
    empty = 0
    for f in range(F):
        U = band_to_dense_plain(band[f * P_w:(f + 1) * P_w])
        tab = table[f * P_w:(f + 1) * P_w].long()            # (P_w, L_w)
        blk = torch.where(dim_of[:, None] < 6, tab[pose_of], -1)
        has = blk >= 0                                       # (n_w, L_w)
        W = torch.where(has[..., None], wb[blk.clamp(min=0), dim_of.clamp(
            max=5)[:, None]], 0.0)                           # (n_w, L_w, lm)
        Vf = vinv[f * L_w:(f + 1) * L_w]
        masks = [has[r * rng_:(r + 1) * rng_].any(0) for r in range(nR)]

        def column(i_rows, l, b):
            s = torch.zeros(len(i_rows), dtype=band.dtype)
            for a in range(lm):
                s = s + W[i_rows, l, a] * Vf[l, a, b]
            return s

        # the diagonal pass: each row over its own landmarks, ascending
        for i in range(n_w):
            acc = torch.zeros((), dtype=band.dtype)
            for l in torch.nonzero(has[i])[:, 0].tolist():
                for b in range(lm):
                    acc = acc + column([i], l, b)[0] * W[i, l, b]
            d[f, i] = U[i, i] - acc
        scal[f] = torch.rsqrt(torch.clamp(d[f], min=1e-12))
        # the tile pass
        nb = -(-n_w // tile)
        per = tile // rng_
        for bi in range(nb):
            for bj in range(bi + 1):
                ri = torch.arange(bi * tile, min(n_w, (bi + 1) * tile))
                rj = torch.arange(bj * tile, min(n_w, (bj + 1) * tile))
                mi = torch.stack(masks[bi * per:(bi + 1) * per]).any(0)
                mj = torch.stack(masks[bj * per:(bj + 1) * per]).any(0)
                common = torch.nonzero(mi & mj)[:, 0].tolist()
                empty += not common
                acc = torch.zeros((len(ri), len(rj)), dtype=band.dtype)
                for l in common:
                    for b in range(lm):
                        acc = acc + column(ri, l, b)[:, None] \
                            * W[rj, l, b][None, :]
                S = U[ri][:, rj] - acc
                tile_ss = S * scal[f, ri][:, None] * scal[f, rj][None, :]
                if bi == bj:
                    assert torch.equal(torch.diagonal(S), d[f, ri])
                    tile_ss = tile_ss + eps * torch.eye(len(ri),
                                                        dtype=band.dtype)
                    tile_ss = torch.tril(tile_ss) + torch.tril(
                        tile_ss, -1).mT
                Ss[f, ri[:, None], rj[None, :]] = tile_ss
                Ss[f, rj[:, None], ri[None, :]] = tile_ss.mT
    return Ss, scal, empty, d


@pytest.mark.parametrize("F,lm", [(1, 1), (2, 1), (4, 1), (1, 3), (2, 3),
                                  (4, 3)])
def test_tile_walk_matches_plain(F, lm):
    wb, vinv, wb_pose, wb_lm, band = fleet_inputs(F, lm)
    P, L = band.shape[0], vinv.shape[0]
    table = k10.fleet_plan(wb_pose, wb_lm, P, L, F)
    assert table.shape == (P, L // F)
    # the table names each kept block at (pose, window landmark)
    kept = wb_lm < L
    assert torch.equal(
        table[wb_pose[kept].long(), (wb_lm[kept] % (L // F)).long()],
        torch.nonzero(kept)[:, 0].int())
    assert int((table >= 0).sum()) == int(kept.sum())
    Ss, scal, empty, _ = tile_walk(wb, vinv, table, band, F, 1e-8)
    want_ss, want_scal = k10.fleet_schur_plain(wb, vinv, wb_pose, wb_lm,
                                               band, F, 1e-8)
    assert empty > 0, "every tile pair shares a landmark"
    assert torch.equal(Ss, Ss.mT)
    assert_rel(Ss, want_ss.numpy(), TOL, "Ss")
    assert_rel(scal, want_scal.numpy(), TOL, "scal")
    # masked dims: identity rows of the scaled system
    n_w = Ss.shape[-1]
    m = 3 * 9
    assert torch.allclose(Ss[:, m, m], torch.full((F,), 1 + 1e-8,
                                                  dtype=Ss.dtype))
    assert float(Ss[:, m, :m].abs().max()) == 0.0
    assert n_w == 24 * 9


def test_tile_walk_without_landmark_columns():
    """lm 0: no landmark is walked, Ss is U scaled."""
    wb, vinv, wb_pose, wb_lm, band = fleet_inputs(2, 1, masked=False)
    wb0, vinv0 = wb[:, :, :0], vinv[:, :0, :0]
    P, L = band.shape[0], vinv.shape[0]
    table = k10.fleet_plan(wb_pose, wb_lm, P, L, 2)
    Ss, scal, _, d = tile_walk(wb0, vinv0, table, band, 2, 1e-8)
    want_ss, want_scal = k10.fleet_schur_plain(wb0, vinv0, wb_pose, wb_lm,
                                               band, 2, 1e-8)
    assert_rel(Ss, want_ss.numpy(), TOL, "Ss")
    assert torch.equal(d[0], torch.diagonal(band_to_dense_plain(band[:24])))
    assert_rel(scal, want_scal.numpy(), TOL, "scal")


def test_fleet_plan_layout_drops_blocks_outside_their_window():
    """A block whose pose lies outside its landmark's window is left out
    of the table, as padding blocks are."""
    wb_pose = torch.tensor([0, 5, 2, 7], dtype=torch.int32)
    wb_lm = torch.tensor([0, 0, 3, 4], dtype=torch.int32)   # L = 4: 4 pads
    table = k10.fleet_plan(wb_pose, wb_lm, 8, 4, 2)
    want = torch.full((8, 2), -1, dtype=torch.int32)
    want[0, 0] = 0           # pose 5 and landmark 0, pose 2 and landmark
    assert torch.equal(table, want)   # 3 lie in different windows
