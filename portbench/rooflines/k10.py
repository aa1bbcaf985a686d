"""Kernel 10 (csrc/fleet_schur.cu, each window's scaled Schur system of a
fused fleet): `chip_smoke.py`'s `_k10_work` and byte count.  Bytes: the W
blocks, V^-1, the plan's table and the band read once, S and the scaling
written once; operations: 2 lm multiply-adds per landmark two rows of a
window share, 2 lm^2 per (row, landmark) for W V^-1, and 4 per element of
the lower triangle for the scaling."""

from __future__ import annotations

import torch

from . import nbytes

WRAPPER = ("ba_tpu_torch.kernels.fleet_schur", "fleet_schur")


def k10_work(table, F, D, lm):
    P, L_w = table.shape
    P_w, n_w = P // F, (P // F) * D
    has = (table >= 0).to(torch.float64).reshape(F, P_w, 1, L_w).expand(
        F, P_w, 6, L_w)
    Hw = torch.zeros((F, P_w, D, L_w), dtype=torch.float64,
                     device=table.device)
    Hw[:, :, :6] = has
    Hw = Hw.reshape(F, n_w, L_w)
    shared = torch.tril(Hw @ Hw.mT).sum()
    rows_lms = Hw.sum()
    return (2 * lm * float(shared) + 2 * lm * lm * float(rows_lms)
            + 4 * F * n_w * (n_w + 1) / 2)


def count(args, kwargs, out):
    wb, vinv, table, band, F = args[0], args[1], args[2], args[3], args[4]
    D, lm = band.shape[-1], vinv.shape[1]
    return dict(bytes=nbytes(wb, vinv, table, band, *out),
                flops=k10_work(table, F, D, lm))


def match(name: str) -> bool:
    return any(k in name for k in ("fleet_prep_kernel", "fleet_prep_u_kernel",
                                   "fleet_tile_kernel"))
