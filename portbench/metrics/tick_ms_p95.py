"""The 95th percentile of the timed window's whole solves (a fleet's
ticks), in ms: the nearest-rank percentile of the window's solve times."""

import math


def read(ctx):
    xs = sorted(ctx["window"]["solve_s"])
    if len(xs) < 20:
        return None
    return 1e3 * xs[min(len(xs) - 1, math.ceil(0.95 * len(xs)) - 1)]
