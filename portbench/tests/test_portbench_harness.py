"""The harness finds every file by its name in `BENCHMARK.json`, and a
traced run gathers what the cell's per-layer readers declare."""

from __future__ import annotations

import importlib
import json
import time

import pytest

from portbench import harness

from .conftest import tiny

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_every_name_has_its_file():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        r = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert callable(r.read), m["name"]
        if hasattr(r, "ROOFLINE"):
            importlib.import_module(f"portbench.rooflines.{r.ROOFLINE}")
    for w in SPEC["workloads"]:
        cl = harness.cell(w["name"])
        for fn in ("setup", "solve", "reference", "outputs_of", "numbers"):
            assert callable(getattr(cl.entry, fn)), (w["name"], fn)
        assert cl.limits, w["name"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_declared_spans(name):
    cl = tiny(name)
    line = harness.run_cell(cl, 2 ** 33 + 1, 0.05, True, "cpu",
                            time.perf_counter(), log=lambda m: None)
    assert set(line["checks"]) == set(cl.limits)
    got = set(line["metrics"])
    for m in cl.per_layer:
        r = importlib.import_module(f"portbench.metrics.{m['name']}")
        if hasattr(r, "SPAN") or hasattr(r, "TAP"):
            assert m["name"] in got, (m["name"], got)
    # the program's functions are themselves again after the run
    from ba_tpu_torch.solver import cg
    assert cg.assemble_blocks.__module__ == "ba_tpu_torch.solver.cg"
    assert cg.assemble_blocks.__name__ == "assemble_blocks"
