"""The readings the limits of `correct` are set from, in one process.

    python3 -m portbench.calibrate --workload <name> --seeds <n> [<n> ...] \
        [--control <k>]

For each seed: the scene, one whole solve of the program (the cell's
entry, at the cell's size), the reference's solve, and the entry's
`numbers`; then, for the first k seeds, the control: the reference itself
computed in TF32 (float32, the operands of every block product rounded to
TF32: `reference.ba.round_tf32`), the precision below the configuration's
float32 with TF32 off, put in the program's place.  Prints one JSON line a
reading.  The benchmark's own runs never run this; `PERF.md` records the
readings and the limits set from them.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from . import harness


def control_numbers(cl: harness.Cell, inputs, ref):
    """The control's numbers against the float64 reference's answer
    `ref`: the reference itself in float32 with TF32, in the program's
    place."""
    e = cl.entry
    ctl = e.reference(inputs, cl, dtype=torch.float32, tf32=True)
    return e.numbers(e.outputs_of(ctl), ref)


def readings(cl: harness.Cell, seed: int, device, control: bool,
             program: bool = True):
    scene_mod = importlib.import_module(
        f"portbench.scenes.{cl.config['scene']}")
    inputs = scene_mod.generate(cl.config, cl.mix, seed, device).rounded(
        torch.float32)
    e = cl.entry
    res = {}
    outs = None
    if program:
        o, _ = e.solve(e.setup(inputs, cl, device))
        outs = {k: (v.detach().double() if torch.is_tensor(v) else v)
                for k, v in o.items()}
        del o
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
    ref = e.reference(inputs, cl)
    if outs is not None:
        res["program"] = e.numbers(outs, ref)
    if control:
        res["control"] = control_numbers(cl, inputs, ref)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0,
                    help="run the control on the first k seeds")
    ap.add_argument("--no-program", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cl = harness.cell(args.workload)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r = readings(cl, seed, "cuda", i < args.control,
                     not args.no_program)
        print(json.dumps(dict(workload=cl.name, seed=seed,
                              seconds=time.perf_counter() - t0, **r)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
