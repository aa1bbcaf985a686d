"""Metric readers, one file per metric of `BENCHMARK.json`, end-to-end and
per-layer alike.

Each module `<metric>.py` has `read(ctx) -> float | None`; `None` means
the run found nothing to read, and the metric is left out of the line.
A per-layer reader may also declare what the traced run has to gather
for it, which the harness does for the cell's metrics and no others:

  SPAN = (module, attribute)   a function of the program, each call
                               timed between two synchronizes in the span
                               phase: ctx["spans"][SPAN], seconds a call;
  TAP = (module, attribute) with tap(args, kwargs, out)
                               a value taken from each call's output in
                               the span phase: ctx["taps"][<metric>];
  ROOFLINE = "<kernel>"        the kernel's counts (`rooflines/<kernel>.py`)
                               of one call: ctx["rooflines"][<kernel>],
                               with the calls in the profiled phase.

`ctx` holds what the run gathered:

  window      the timed window: solves, elapsed_s, solve_s (each whole
              solve's seconds), iterations (GN iterations), syncs
              (host reads through `ba_tpu_torch.utils.sync.item`);
  setup_s     process start to the end of the warm-up solve;
  peak_bytes  `torch.cuda.max_memory_allocated()` after the window;
  spans, taps the span phase's, with its `iterations` under spans;
  trace       the profiled phase (`trace.read`) with its `iterations`;
  rooflines   as above.
"""

from __future__ import annotations

import importlib


def span_ms_per_call(ctx, span):
    xs = ctx["spans"].get(span) or []
    return 1e3 * sum(xs) / len(xs) if xs else None


def roofline_pct(ctx, kernel):
    """100 * bound / device time of one call, from the profiled phase."""
    from ..rooflines import bound_s

    rec = ctx["rooflines"].get(kernel)
    if not rec or not rec.get("calls"):
        return None
    mod = importlib.import_module(f"portbench.rooflines.{kernel}")
    dev_s = sum(s for name, s in ctx["trace"]["kernel_s"].items()
                if mod.match(name))
    if dev_s <= 0:
        return None
    return 100.0 * bound_s(rec)[0] / (dev_s / rec["calls"])
