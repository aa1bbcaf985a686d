"""A run with the timed path broken underneath reads `correct` false.

Each test skips the harness's look for a card and drives the rest of a
run (`harness.run_cell` on the CPU, at a tiny size of the cell) with one
fault planted in the program: a step that leaves the state unchanged;
half of the projection rows left out, the rest weighted double; an
answer altered where it is produced.  (A cell runs on one card, so no
exchange between cards can be left out.)  The same run unbroken reads
`correct` true."""

from __future__ import annotations

import math
import time

import pytest
import torch

from portbench import harness

from .conftest import tiny

CELLS = ["bal-venice.gn-pcg", "euroc-mh01.fleet128"]


def _run(name):
    cl = tiny(name)
    return harness.run_cell(cl, 424242, 0.05, False, "cpu",
                            time.perf_counter(), log=lambda m: None)


def _unchanged(monkeypatch):
    from ba_tpu_torch.solver import step
    monkeypatch.setattr(step, "apply_update",
                        lambda problem, config, dp, dl, scale=1.0: problem)


def _half_rows(monkeypatch):
    from ba_tpu_torch.core.residuals import reprojection as rp
    orig = rp.evaluate

    def broken(problem, config, with_jacobians=True):
        e = orig(problem, config, with_jacobians)
        n = e.r.shape[0]
        keep = (torch.arange(n) % 2 == 0).to(e.r.dtype) * math.sqrt(2.0)
        k3 = keep[:, None, None]
        return rp.ProjEval(e.r * keep[:, None], e.j_meas * k3,
                           e.j_ref * k3, e.j_lm * k3, e.j_cal * k3,
                           e.err_sq * keep * keep)
    monkeypatch.setattr(rp, "evaluate", broken)


def _altered(monkeypatch):
    import dataclasses

    from ba_tpu_torch.solver import step
    orig_fixed = step.solve_fixed

    def alter(p):
        t = p.poses.t.clone()
        k = int(torch.nonzero(p.poses.active)[0])
        t[k] = t[k] + 1.0
        return dataclasses.replace(p, poses=dataclasses.replace(p.poses, t=t))

    def fixed(*a, **k):
        p, c, d = orig_fixed(*a, **k)
        return alter(p), c, d
    monkeypatch.setattr(step, "solve_fixed", fixed)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = _run(name)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half_rows, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault, monkeypatch):
    fault(monkeypatch)
    line = _run(name)
    assert not line["correct"], line["checks"]
