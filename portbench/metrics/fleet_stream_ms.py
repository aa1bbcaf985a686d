"""Stream milliseconds of one dense fleet solve (the program's
`reduced.fleet_dense` span: `solver.banded.solve_reduced_fleet_dense`,
K10, the batched Cholesky, its solves and the back-substitution), in the
profiled phase."""

from .host_wait_ms import program_summary


def read(ctx):
    got = program_summary(ctx)
    s = got[0].get("reduced.fleet_dense") if got is not None else None
    if not s or s["stream_s"] is None:
        return None
    return 1e3 * s["stream_s"] / s["calls"]
