"""Huber robust weighting with median-based scale.

Port of `ba_tpu/core/robust.py`: sigma = sqrt(lower median of the squared
errors) by a full sort of a masked array, c = 1.2107 * sigma (Zhang's
constant); residuals with error e > c get weight c/e.  Conditioning edges
get their own sigma.
"""

from __future__ import annotations

import torch

HUBER_C = 1.2107


def masked_median(x, valid):
    """Lower median (nth_element at (n-1)//2) over entries where valid; 0
    for an empty population.  Invalid entries sort last behind the dtype's
    largest finite value."""
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(valid, x, big)).values
    n = torch.sum(valid)
    idx = torch.clamp(n - 1, min=0) // 2
    med = xs.gather(0, idx.reshape(1))[0]       # no host read of idx
    return torch.where(n > 0, med, torch.zeros_like(med))


def huber_weights(err_sq, valid, cond, outlier_threshold=1.0):
    """Per-residual robust weights in (0, 1], split normal vs conditioning
    populations."""
    def weights_for(pop):
        sigma = torch.sqrt(masked_median(err_sq, valid & pop))
        c = HUBER_C * sigma * outlier_threshold
        e = torch.sqrt(torch.clamp(err_sq, min=1e-30))
        w = torch.where(e > c, c / e, torch.ones_like(e))
        # degenerate population (sigma == 0): no reweighting
        return torch.where(sigma > 0, w, torch.ones_like(w))

    w_norm = weights_for(~cond)
    w_cond = weights_for(cond)
    return torch.where(cond, w_cond, w_norm)
