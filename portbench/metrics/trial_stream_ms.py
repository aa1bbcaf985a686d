"""Stream milliseconds of the program's `trial` spans (`solver.step._cost`,
the trial costs) per GN iteration, in the profiled phase."""

from .host_wait_ms import program_summary


def read(ctx):
    got = program_summary(ctx)
    s = got[0].get("trial") if got is not None else None
    if not s or s["stream_s"] is None:
        return None
    return 1e3 * s["stream_s"] / got[2]
