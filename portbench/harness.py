"""One run of one cell: set-up, the timed window, the traced phases, the
check against the plain reference, and the result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The run finds everything by the cell's names in `BENCHMARK.json`: the
configuration's file, the mix (`mixes/<traffic>.json`), the program entry
the mix names (`entries/<entry>.py`), the limits
(`limits/<workload>.json`) and one reader a metric (`metrics/<name>.py`).
Its steps:

  1. set-up: the scene from the seed (`scenes/<scene>.py`, on the card),
     the entry's `setup` (the program's state in the configuration's
     precision), and one whole solve that loads (on a checkout's first
     run: builds) every kernel; `setup_s` runs from the process start to
     the end of that solve;
  2. the window: the entry's whole solves from the same start in a closed
     loop for `--seconds`, each closed by a synchronize; a seeded sample
     of the solves' outputs is kept for the check;
  3. with `--trace 1`, after the window: a span phase (the functions the
     cell's per-layer readers declare, wrapped: each call between two
     synchronizes, or its output tapped, or a kernel's shapes seen), then
     a profiled phase (`trace.py`, no span);
  4. the memory peak is read, and the readers of the cell's metrics
     (end-to-end with `--trace 0`, per-layer with `--trace 1`) read what
     the run gathered;
  5. the program's state is freed, the entry's `reference` solves the
     same scene in float64 (`reference/`), and the entry's `numbers` hold
     each kept output against it and the limits.

The run refuses to start without the CUDA devices the cell asks for, and
fails if `jax`, `jaxlib`, `flax` or `ba_tpu` is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

from .program import sync as _sync

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ba_tpu")
KEPT = 4                 # sampled outputs checked, besides the first and last
SPAN_SECONDS = 4.0       # the span phase: at least 2 solves and this long
PROFILE_SECONDS = 2.0    # the profiled phase: at least 1 solve and this long


def _load(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def entry(self):
        return importlib.import_module(f"portbench.entries.{self.mix['entry']}")


def cell(name: str, root: Path = ROOT) -> Cell:
    spec = _load(root / "BENCHMARK.json")
    ws = [w for w in spec["workloads"] if w["name"] == name]
    if not ws:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    w = ws[0]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name=name, chips=w["chips"], config=_load(root / conf["file"]),
                mix=_load(PKG / "mixes" / f"{w['traffic']}.json"),
                limits=_load(PKG / "limits" / f"{name}.json"),
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])


def readers(metrics: list) -> dict:
    return {m["name"]: importlib.import_module(f"portbench.metrics.{m['name']}")
            for m in metrics}


# ---------------------------------------------------------------------------
# wrapping the program's entry points (traced run only)
# ---------------------------------------------------------------------------

class Wrapped:
    """Module attributes replaced for a phase and put back after it."""

    def __init__(self):
        self._undo = []

    def wrap(self, module: str, attr: str, make):
        """Replace `module.attr` by `make(orig)`; the replacement carries the
        original's attributes (a kernel wrapper counts its launches on
        itself by its module-level name) and hands them back on restore."""
        mod = importlib.import_module(module)
        orig = getattr(mod, attr)
        new = make(orig)
        new.__dict__.update(orig.__dict__)
        setattr(mod, attr, new)
        self._undo.append((mod, attr, orig, new))

    def restore(self):
        for mod, attr, orig, new in reversed(self._undo):
            orig.__dict__.update(new.__dict__)
            setattr(mod, attr, orig)
        self._undo.clear()


def _roofline_mods(rds: dict) -> dict:
    return {r.ROOFLINE: importlib.import_module(
        f"portbench.rooflines.{r.ROOFLINE}")
        for r in rds.values() if hasattr(r, "ROOFLINE")}


def _span_phase(solve, rds: dict, roofs: dict, device):
    """Whole solves with the functions the readers declare wrapped: spans
    between synchronizes, taps of the outputs, the kernels' shapes seen
    once.  Returns (spans, taps, counts)."""
    spans, taps, counts = {}, {}, {}
    w = Wrapped()

    def timed(xs):
        def make(f):
            def g(*a, **k):
                _sync(device)
                t0 = time.perf_counter()
                out = f(*a, **k)
                _sync(device)
                xs.append(time.perf_counter() - t0)
                return out
            return g
        return make

    def tapped(fn, xs):
        def make(f):
            def g(*a, **k):
                out = f(*a, **k)
                xs.append(fn(a, k, out))
                return out
            return g
        return make

    def roof_make(key, mod):
        def make(f):
            def g(*a, **k):
                out = f(*a, **k)
                if key not in counts and getattr(mod, "counted",
                                                 lambda *_: True)(a, k):
                    counts[key] = mod.count(a, k, out)
                return out
            return g
        return make

    for target in sorted({r.SPAN for r in rds.values() if hasattr(r, "SPAN")}):
        spans[target] = []
        w.wrap(*target, timed(spans[target]))
    for name, r in rds.items():
        if hasattr(r, "TAP"):
            taps[name] = []
            w.wrap(*r.TAP, tapped(r.tap, taps[name]))
    for key, mod in roofs.items():
        w.wrap(*mod.WRAPPER, roof_make(key, mod))
    iters = solves = 0
    t0 = time.perf_counter()
    try:
        while solves < 2 or time.perf_counter() - t0 < SPAN_SECONDS:
            _, it = solve()
            iters += it
            solves += 1
    finally:
        w.restore()
    spans["iterations"] = iters
    return spans, taps, counts


def _profile_phase(solve, roofs: dict):
    from . import trace

    calls = {k: 0 for k in roofs}
    w = Wrapped()

    def roof_make(key, mod):
        def make(f):
            def g(*a, **k):
                if getattr(mod, "counted", lambda *_: True)(a, k):
                    calls[key] += 1
                return f(*a, **k)
            return g
        return make

    for key, mod in roofs.items():
        w.wrap(*mod.WRAPPER, roof_make(key, mod))
    iters = [0]

    def run():
        _, it = solve()
        iters[0] += it

    try:
        window, _, prof = trace.profile(run, PROFILE_SECONDS)
    finally:
        w.restore()
    rec = trace.read(prof, window)
    rec["iterations"] = iters[0]
    return rec, calls


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def _window(solve, seconds: float, seed: int):
    """Whole solves in a closed loop for `seconds`: the window's record and
    the outputs kept for the check (the first, the last and a reservoir of
    KEPT drawn from the seed)."""
    from ba_tpu_torch.utils import sync as sync_mod

    rng = random.Random(seed)
    first = last = None
    sample, offered = [], 0
    solve_s = []
    n = iters = 0
    syncs0 = sync_mod.item.count
    t0 = time.perf_counter()
    while True:
        s0 = time.perf_counter()
        out, it = solve()
        solve_s.append(time.perf_counter() - s0)
        iters += it
        if n == 0:
            first = out
        else:
            if last is not None:
                offered += 1
                if len(sample) < KEPT:
                    sample.append(last)
                else:
                    j = rng.randrange(offered)
                    if j < KEPT:
                        sample[j] = last
            last = out
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    kept = [first] + sample + ([last] if last is not None else [])
    return dict(solves=n, iterations=iters, syncs=sync_mod.item.count - syncs0,
                solve_s=solve_s, elapsed_s=elapsed), kept


def run_cell(cl: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, log=None, marks=None):
    """The result line's dict of one run of `cl` on `device` ("cuda", or
    "cpu" for the tests, which skip the look for a card); `marks` are the
    set-up's earlier (name, time) steps, for its log line."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    on_card = torch.device(device).type == "cuda"
    entry = cl.entry
    scene_mod = importlib.import_module(
        f"portbench.scenes.{cl.config['scene']}")
    import ba_tpu_torch.solver.step  # noqa: F401
    marks = list(marks or []) + [("imports", time.perf_counter())]
    scene = scene_mod.generate(cl.config, cl.mix, seed, device)
    prog_dtype = getattr(torch, cl.config["solver"].get("dtype", "float32"))
    # both sides start from the numbers the program's precision holds
    inputs = scene.rounded(prog_dtype)
    del scene
    _sync(device)
    marks.append(("scene", time.perf_counter()))
    prog = entry.setup(inputs, cl, device)
    _sync(device)
    marks.append(("problem", time.perf_counter()))
    entry.solve(prog)                # loads (first run: builds) the kernels
    marks.append(("first solve", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    parts, prev = [], t_start
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    log(f"portbench: {cl.name} seed {seed}: set-up {setup_s:.3f} s ("
        + ", ".join(parts) + ")")

    def solve():
        return entry.solve(prog)

    window, kept = _window(solve, seconds, seed)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        raise RuntimeError("portbench: loaded in the benchmark's process: "
                           + ", ".join(loaded))
    log(f"portbench: window {window['elapsed_s']:.3f} s, {window['solves']} "
        f"solves, {window['iterations']} iterations, {window['syncs']} host "
        "reads")

    ctx = dict(window=window, setup_s=setup_s)
    device_rec, breakdown = {}, None
    rds = readers(cl.per_layer if traced else cl.end_to_end)
    if traced:
        roofs = _roofline_mods(rds)
        spans, taps, counts = _span_phase(solve, rds, roofs, device)
        rec, calls = (_profile_phase(solve, roofs) if on_card
                      else (dict(busy_s=0.0, window_s=0.0, kernel_s={},
                                 kernel_n={}, launches=0, iterations=0,
                                 breakdown=None), {}))
        rooflines = {k: dict(counts[k], calls=calls.get(k, 0))
                     for k in counts}
        ctx.update(spans=spans, taps=taps, trace=rec, rooflines=rooflines)
        for k, r in rooflines.items():
            names = sorted({nm for nm in rec["kernel_s"]
                            if roofs[k].match(nm)})
            log(f"portbench: roofline {k}: {r}; kernels {names}")
        device_rec = dict(busy_s=rec["busy_s"], window_s=rec["window_s"])
        breakdown = rec["breakdown"]
    ctx["peak_bytes"] = peak = (torch.cuda.max_memory_allocated() if on_card
                                else 0)
    metrics = {}
    units = {m["name"]: m["unit"] for m in cl.per_layer + cl.end_to_end}
    for name, r in rds.items():
        v = r.read(ctx)
        if v is not None:
            metrics[name] = dict(value=float(v), unit=units[name])

    # the check, with the program's state freed
    outs = [{k: (v.detach().to("cpu", torch.float64)
                 if torch.is_tensor(v) else v) for k, v in o.items()}
            for o in kept]
    del prog, kept
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    ref = entry.reference(inputs, cl)
    ref_s = time.perf_counter() - r0
    results = [entry.numbers(o, ref) for o in outs]
    checks, failed = {}, 0
    for r in results:
        bad = any(not (r[k] <= lim) for k, lim in cl.limits.items())
        failed += bool(bad)
    for k, lim in cl.limits.items():
        v = max(r[k] for r in results)
        checks[k] = dict(value=v, limit=lim)
    info = {k: max(r[k] for r in results) for k in results[0]
            if k not in cl.limits}
    correct = failed == 0
    log(f"portbench: reference {ref_s:.3f} s; {ref.get('summary', '')}; "
        "not compared: " + ", ".join(f"{k} {v:.6g}" for k, v in info.items()))
    line = dict(correct=correct, attempted=window["solves"], failed=failed,
                metrics=metrics, device=_device(cl, peak, on_card, device_rec))
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def _device(cl: Cell, peak: int, on_card: bool, extra: dict) -> dict:
    import torch
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    return dict(platform="gpu" if on_card else "cpu", kind=kind,
                count=cl.chips, memory_peak_bytes=int(peak), **extra)


def _power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = PKG / "_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    cl = cell(args.workload)
    import torch
    marks = [("torch", time.perf_counter())]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cl.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cl.chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    torch.zeros(1, device="cuda")
    marks.append(("cuda context", time.perf_counter()))
    line = run_cell(cl, args.seed, args.seconds, bool(args.trace), "cuda",
                    t_start, marks=marks)
    # the card's name and power limit, read after the measurement; the
    # numbers compared, each beside its limit, last
    print(f"portbench: {_power_line()}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
