"""Huber robust weighting with median-based scale.

Port of `ba_tpu/core/robust.py`: sigma = sqrt(lower median of the squared
errors) by a full sort of a masked array, c = 1.2107 * sigma (Zhang's
constant); residuals with error e > c get weight c/e.  Conditioning edges
get their own sigma.

With a `mesh` (`parallel/mesh.py`, rows sharded over ranks) the medians
are taken over the global population: one gather of every rank's errors
and masks, in rank order, so the lower median does not depend on the
rank count (ba_tpu's `axis_name`, an `all_gather` inside `shard_map`).
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


def _global_rows(err_sq, valid, cond, mesh):
    """(err_sq, valid, cond) of every rank's rows, in rank order: one
    `gather_rows` of the three as columns."""
    if mesh is None or mesh.size == 1:
        return err_sq, valid, cond
    dt = err_sq.dtype
    g = mesh.gather_rows(torch.stack([err_sq, valid.to(dt), cond.to(dt)],
                                     dim=1))
    return g[:, 0], g[:, 1] > 0, g[:, 2] > 0


def huber_weights(err_sq, valid, cond, outlier_threshold=1.0, mesh=None):
    """Per-residual robust weights in (0, 1], split normal vs conditioning
    populations; with `mesh`, the sigmas of the populations over every
    rank's rows."""
    g_err, g_valid, g_cond = _global_rows(err_sq, valid, cond, mesh)

    def weights_for(pop, g_pop):
        sigma = torch.sqrt(masked_median(g_err, g_valid & g_pop))
        c = HUBER_C * sigma * outlier_threshold
        e = torch.sqrt(torch.clamp(err_sq, min=1e-30))
        w = torch.where(e > c, c / e, torch.ones_like(e))
        # degenerate population (sigma == 0): no reweighting
        return torch.where(sigma > 0, w, torch.ones_like(w))

    w_norm = weights_for(~cond, ~g_cond)
    w_cond = weights_for(cond, g_cond)
    return torch.where(cond, w_cond, w_norm)
