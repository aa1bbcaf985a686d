"""Kernel 6 (csrc/schur_matvec.cu, one Schur product's projection rows):
`chip_smoke.py`'s `phase_timing_cg_fleet` count.  Bytes as the function
needs them: J_m, J_r and j_l (24 + 2 lm values) and three 4-byte ids a
row, the tile table, V^-1 (lm > 0), x read once, the rows written once;
operations: u (24 multiply-adds), j_l^T u (2), w (2) and 12 outputs of 2
multiply-adds a row, one product with V^-1 a landmark.  At the PCG cell of
`PERF.md` (85,823 rows, lm 3, f32) this is 14,129,680 B."""

from __future__ import annotations

from . import nbytes

WRAPPER = ("ba_tpu_torch.kernels.schur_matvec", "schur_matvec")


def k6_counts(Nr, lm, L, itemsize, tiles, x, out, vinv):
    b = (Nr * ((24 + 2 * lm) * itemsize + 12) + nbytes(tiles, x, out)
         + (nbytes(vinv) if lm else 0))
    return dict(bytes=b, flops=Nr * 2 * (24 + 2 + 2 + 24) + L)


def count(args, kwargs, out):
    pack, plan, vinv, x = args[0], args[1], args[2], args[3]
    lm = pack.lm
    rows = out[0] if isinstance(out, tuple) else out
    Nr = rows.shape[0]
    return k6_counts(Nr, lm, vinv.shape[0], x.element_size(), plan.tiles, x,
                     rows, vinv)


def match(name: str) -> bool:
    return "schur_matvec_kernel" in name
