"""The plain reference computes what the program computes: on the CPU in
float64, with the damping and covariance floor the program takes in
float64, the two solves of every cell agree to rounding."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from .conftest import tiny


@pytest.mark.parametrize("name", ["bal-venice.gn-pcg", "euroc-mh01.fleet128"])
def test_reference_agrees_with_the_program_in_f64(name):
    cl = tiny(name)
    mod = __import__(f"portbench.scenes.{cl.config['scene']}",
                     fromlist=["generate"])
    sc = mod.generate(cl.config, cl.mix, 5, "cpu").rounded(torch.float32)
    c64 = dict(cl.config, solver=dict(cl.config["solver"], dtype="float64"))
    cl64 = dataclasses.replace(cl, config=c64)
    out, _ = cl.entry.solve(cl.entry.setup(sc, cl64, "cpu"))
    ref = cl.entry.reference(sc, cl64)
    sem = ref["sem"]
    if sem.imu is not None:
        assert sem.imu.eps == 1e-12
    assert sem.damping == 1e-8
    st = ref["state"]
    rel = ((out["costs"] - ref["costs"]).abs() / ref["costs"]).max()
    assert float(rel) < 1e-7
    assert float((out["t"] - st.t).abs().max()) < 1e-6
    lm = out["lm"][:, :3] if sem.lm_size == 3 else out["lm"][:, 3]
    assert float((lm - st.lm).abs().max()) < 1e-6
