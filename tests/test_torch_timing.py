"""The program's spans and counters (`ba_tpu_torch.utils.timing`) on the
CPU, at tiny sizes: a solve under `enable()` makes one tree rooted at its
`solve` span; with tracing off nothing is recorded; no span adds a host
read; the PCG's counters equal its results; under a CPU profiler the
spans are ranges of the Chrome trace, and `attribute` puts each idle gap
down to the innermost span open at its start; threads keep their own
span stacks and lose no count."""

import dataclasses
import json
import sys
import threading
from types import SimpleNamespace

import pytest
import torch

from ba_tpu_torch.core.problem import BAConfig, prepare_landmarks
from ba_tpu_torch.io import simulate_vins as sv
from ba_tpu_torch.solver import cg, step
from ba_tpu_torch.utils import sync, timing

CFG = BAConfig(pose_dim=9, lm_size=1, use_dogleg=False)
ROUTES = {"gn": CFG, "dogleg": dataclasses.replace(CFG, use_dogleg=True),
          "pcg": dataclasses.replace(CFG, use_cg_solver=True)}


@pytest.fixture(scope="module")
def problem():
    sim = sv.simulate(n_poses=6, n_lms=24, seed=0)
    p, _, _ = sv.build_problem(sim, CFG, device="cpu")
    return prepare_landmarks(p, CFG)


@pytest.fixture(autouse=True)
def empty_store():
    timing.reset()
    yield
    timing.reset()


def _solve(p, cfg):
    return step.solve_fixed(p, cfg, True, 2)


def test_solve_makes_one_tree_rooted_at_solve(problem):
    with timing.enable():
        _solve(problem, CFG)
    recs = timing._records
    assert recs[0].name == "solve" and recs[0].parent is None
    assert {r.sid for r in recs} == {recs[0].sid}
    assert all(r.parent is not None for r in recs[1:])
    parent = {r.name: r.parent.name for r in recs[1:]}
    assert parent["plan"] == "solve" and parent["iteration"] == "solve"
    for name in ("reweight", "build", "reduced.dense", "cauchy", "update",
                 "trial"):
        assert parent[name] == "iteration", name
    assert {r.parent.name for r in recs if r.name == "imu"} == {
        "iteration", "trial"}
    s = timing.summary()["spans"]
    assert s["iteration"]["calls"] == 2 and s["solve"]["calls"] == 1
    assert s["iteration"]["stream_s"] is None          # no CUDA here
    sv_ = s["solve"]
    assert sv_["self_s"] == pytest.approx(
        sv_["host_s"] - s["plan"]["host_s"] - s["iteration"]["host_s"],
        rel=1e-6, abs=1e-9)
    with timing.enable():
        _solve(problem, CFG)
    assert len({r.sid for r in timing._records}) == 2


def test_tracing_off_records_nothing(problem):
    n0 = sync.item.count
    _solve(problem, ROUTES["pcg"])
    off = sync.item.count - n0
    assert timing._records == [] and timing._counters == {}
    assert timing.summary() == dict(spans={}, counters={})
    with timing.enable():
        _solve(problem, ROUTES["pcg"])
    assert sync.item.count - n0 - off == off > 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_spans_add_no_host_read(problem, route):
    cfg = ROUTES[route]
    n0 = sync.item.count
    _solve(problem, cfg)
    off = sync.item.count - n0
    with timing.enable():
        _solve(problem, cfg)
    on = sync.item.count - n0 - off
    assert on == off
    reads = timing.summary()["spans"].get("host_read", {}).get("calls", 0)
    assert reads == off


def test_pcg_counters_equal_its_results(problem):
    cfg = ROUTES["pcg"]
    P, D = problem.poses.q.shape[0], cfg.pose_dim
    ie = step._imu_eval(problem, cfg, True, True)
    bs, marg_H = cg.assemble_blocks(problem, cfg, ie)
    results = []
    with timing.enable():
        for tol, cap in ((1e-6, 100), (1e-2, 100), (1e-9, 13)):
            c = dataclasses.replace(cfg, cg_tolerance=tol,
                                    cg_max_iterations=cap)
            results.append(cg.pcg_solve(bs, marg_H, c, P, D))
    got = timing.summary()
    n = got["counters"]
    assert n["pcg.iterations"] == sum(int(r.iterations) for r in results)
    assert n["pcg.products"] == sum(r.matvecs for r in results)
    assert n["pcg.stop_reads"] == sum(r.reads for r in results)
    assert got["spans"]["pcg.product"]["calls"] == n["pcg.products"]
    assert n["pcg.iterations"] < n["pcg.products"]      # masked tails


def test_profiler_ranges_and_attribute(problem, tmp_path):
    with timing.trace_to(str(tmp_path)) as prof:
        _solve(problem, CFG)
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"solve", "iteration", "build", "trial"} <= names
    # the store filled while the profiler recorded, without enable()
    assert timing.summary()["spans"]["iteration"]["calls"] == 2
    idle = timing.attribute(prof)
    assert isinstance(idle, dict)
    assert all(isinstance(k, str) and v >= 0 for k, v in idle.items())


def _event(name, start, end, cuda=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU),
        is_user_annotation=False)


def test_attribute_names_each_gap_by_its_innermost_span():
    timing._names.update({"solve", "iteration", "host_read"})
    host = [_event("solve", 0, 100), _event("iteration", 10, 60),
            _event("host_read", 20, 30), _event("aten::add", 40, 45),
            _event("iteration", 60, 95)]
    dev = [_event("k", 0, 5, True), _event("k", 15, 25, True),
           _event("k", 22, 33, True), _event("k", 50, 70, True),
           _event("k", 90, 99, True), _event("k", 110, 120, True),
           _event("k", 130, 140, True), _event("annotation", 0, 140, True)]
    dev[-1].is_user_annotation = True          # a range drawn on the device
    prof = SimpleNamespace(events=lambda: host + dev)
    # the gaps: 5-15 under solve (the iteration opens at 10), 33-50 under
    # the first iteration (its read closed at 30), 70-90 under the second,
    # 99-110 under solve again, 120-130 under no span
    assert timing.attribute(prof) == pytest.approx(
        {"solve": 21e-6, "iteration": 37e-6, "(no span)": 10e-6})


def test_threads_keep_their_stacks_and_counts():
    n_threads, n = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(n):
                with timing.span(f"root{k}"):
                    with timing.span(f"leaf{k}"):
                        timing.count("n", 1)

        with timing.enable():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    s = timing.summary()
    assert s["counters"]["n"] == n_threads * n
    for r in timing._records:
        k = r.name.removeprefix("root").removeprefix("leaf")
        assert (r.parent is None) == r.name.startswith("root")
        assert r.parent is None or r.parent.name == f"root{k}"
    assert all(s["spans"][f"leaf{k}"]["calls"] == n
               for k in range(n_threads))
