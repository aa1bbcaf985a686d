"""Stream milliseconds of one build (the program's `build` span:
`solver.cg.assemble_blocks` / `solver.assemble.assemble`), between the
span's two CUDA events, in the profiled phase."""

from .host_wait_ms import program_summary


def read(ctx):
    got = program_summary(ctx)
    s = got[0].get("build") if got is not None else None
    if not s or s["stream_s"] is None:
        return None
    return 1e3 * s["stream_s"] / s["calls"]
