"""Stream milliseconds of one PCG reduced solve (the program's
`reduced.cg` span: `solver.cg.solve_reduced_cg`, with the landmark
back-substitution), in the profiled phase."""

from .host_wait_ms import program_summary


def read(ctx):
    got = program_summary(ctx)
    s = got[0].get("reduced.cg") if got is not None else None
    if not s or s["stream_s"] is None:
        return None
    return 1e3 * s["stream_s"] / s["calls"]
