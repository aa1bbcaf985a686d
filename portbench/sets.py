"""Full sets of one cell, run one after another, and their spreads: the
readings `BENCHMARK.json`'s bounds are set from.

    python3 -m portbench.sets --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--sets 2] [--traced <n> ...] --out <dir>

Runs `python3 -m portbench.run` once a seed, the same seeds in each set,
then once a `--traced` seed with `--trace 1`; keeps each run's standard
output and error as `<dir>/<set>_<i>.out` / `.err` (the traced runs' set
is `t`), and prints a JSON line a run and, per set and metric, the
median and the spread: the distance between the first and third quartile
(`statistics.quantiles(values, n=4)`) as a share of the median, over all
runs and with the run farthest from the median left out.  `setup_s`
leaves out the first run of the call, which may build the kernels.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def spread(xs: list) -> float:
    q1, _, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / statistics.median(xs)


def _trimmed(xs: list) -> list:
    m = statistics.median(xs)
    far = max(range(len(xs)), key=lambda i: abs(xs[i] - m))
    return xs[:far] + xs[far + 1:]


def _run(workload, seed, seconds, trace, out: Path, tag: str) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    p = subprocess.run(cmd, capture_output=True, text=True)
    (out / f"{tag}.out").write_text(p.stdout)
    (out / f"{tag}.err").write_text(p.stderr)
    lines = p.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        line = {}
    rec = dict(tag=tag, seed=seed, rc=p.returncode,
               correct=line.get("correct"),
               metrics={k: v["value"] for k, v in
                        line.get("metrics", {}).items()},
               checks={k: v["value"] for k, v in
                       line.get("checks", {}).items()})
    print(json.dumps(rec), flush=True)
    return rec


def summary(sets: list) -> dict:
    """{metric: [dict(median, spread, spread_trimmed) per set]}."""
    out = {}
    first = True
    for runs in sets:
        names = sorted({k for r in runs for k in r["metrics"]})
        for k in names:
            xs = [r["metrics"][k] for r in runs if k in r["metrics"]]
            if k == "setup_s" and first:
                xs = xs[1:]
            if len(xs) < 3:
                continue
            out.setdefault(k, []).append(dict(
                median=statistics.median(xs), spread=spread(xs),
                spread_trimmed=spread(_trimmed(xs)) if len(xs) > 3 else None,
                values=xs))
        first = False
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sets = []
    for s in range(args.sets):
        sets.append([_run(args.workload, seed, args.seconds, 0, out,
                          f"s{s + 1}_{i + 1}")
                     for i, seed in enumerate(args.seeds)])
    traced = [_run(args.workload, seed, args.seconds, 1, out, f"t_{i + 1}")
              for i, seed in enumerate(args.traced)]
    runs = [r for rs in sets for r in rs] + traced
    print(json.dumps(dict(workload=args.workload,
                          runs=len(runs),
                          correct=sum(bool(r["correct"]) for r in runs),
                          summary=summary(sets),
                          traced=summary([traced]) if len(traced) >= 3
                          else None)), flush=True)
    return 0 if all(r["rc"] == 0 and r["correct"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
