"""The control reads `correct` false: the plain reference computed in
TF32 (float32, every block product's operands rounded to TF32: the
precision below the configuration's float32 with TF32 off), put in the
program's place, fails at least one of the cell's limits.  It needs the card, and runs at a size a test holds (`small`);
`PERF.md` gives the control's readings at the cells' own sizes, from
`python3 -m portbench.calibrate --control 3`."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate

from .conftest import small

CELLS = ["bal-venice.gn-pcg", "euroc-mh01.fleet128"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name, card):
    import importlib

    cl = small(name)
    mod = importlib.import_module(f"portbench.scenes.{cl.config['scene']}")
    inputs = mod.generate(cl.config, cl.mix, 31337, card).rounded(
        torch.float32)
    ref = cl.entry.reference(inputs, cl)
    n = calibrate.control_numbers(cl, inputs, ref)
    assert any(not (n[k] <= lim) for k, lim in cl.limits.items()), n
