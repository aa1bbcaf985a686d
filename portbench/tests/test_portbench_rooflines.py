"""The benchmark's copies of the kernels' counts give `chip_smoke.py`'s
own counts at its shapes."""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from portbench.rooflines import k1, k2, k6, k10

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke  # noqa: E402


def test_k6_at_the_pcg_configuration():
    e = chip_smoke.CG_EXPECTED
    Nr, L, P = e["Nr"], e["L"], e["P"]
    tiles = torch.zeros(-(-Nr // 224) + 1, dtype=torch.int32)
    got = k6.k6_counts(Nr, 1, L, 4, tiles, torch.zeros(P * 9),
                       torch.zeros(Nr, 2, 6), torch.zeros(L, 1, 1))
    assert got["bytes"] == 14129680


def test_k1_and_k2_operations():
    assert k1.K1_FLOPS_PER_ROW == chip_smoke.K1_FLOPS_PER_ROW
    for Ni, steps, R, D in ((1023, 10230, 15, 15), (8064, 161280, 15, 15),
                            (599, 60000, 9, 9)):
        assert k2.k2_flops(Ni, steps, R, D) == chip_smoke._k2_flops(
            Ni, steps, R, D, True)


def test_k10_work():
    g = torch.Generator().manual_seed(0)
    F, P_w, L_w = 4, 8, 12
    table = torch.where(torch.rand(F * P_w, L_w, generator=g) < 0.4,
                        torch.arange(L_w).expand(F * P_w, L_w), -1)
    got = k10.k10_work(table, F, 15, 1)
    want, _ = chip_smoke._k10_work(table, F, 15, 1)
    assert got == want
