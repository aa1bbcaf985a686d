"""Shared helpers of the benchmark's tests: tiny cells that run on the
CPU, and the card fixture of the tests marked `cuda`."""

from __future__ import annotations

import dataclasses

import pytest

from portbench import harness

# tiny versions of the cells: the same code paths at sizes a CPU test holds
TINY_BAL = dict(cameras=16, points=80, observations=400)


def tiny(cell_name: str) -> harness.Cell:
    cl = harness.cell(cell_name)
    c, m = dict(cl.config), dict(cl.mix)
    if c["scene"] == "bal":
        c.update(TINY_BAL)
        c["geometry"] = dict(c["geometry"], max_track=12)
    else:
        c["geometry"] = dict(c["geometry"], features=12, track_max=6)
        m.update(vehicles=3, window_keyframes=10)
    return dataclasses.replace(cl, config=c, mix=m)


def small(cell_name: str) -> harness.Cell:
    """A size between `tiny` and the cell's own, for the tests that run on
    the card: a tenth of BAL's points, 8 vehicles of the fleet, 60
    features an image."""
    cl = harness.cell(cell_name)
    c, m = dict(cl.config), dict(cl.mix)
    if c["scene"] == "bal":
        c.update(points=99392, observations=500195)
    else:
        c["geometry"] = dict(c["geometry"], features=60)
        m.update(vehicles=8)
    return dataclasses.replace(cl, config=c, mix=m)


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control runs in TF32)")
    return "cuda"
