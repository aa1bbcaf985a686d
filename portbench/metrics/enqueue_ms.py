"""Host milliseconds per GN iteration inside the program's `iteration`
spans less the `host_read` spans nested in them: the host's own Python
and launches, in the profiled phase."""

from .host_wait_ms import program_summary


def read(ctx):
    got = program_summary(ctx)
    if got is None or "iteration" not in got[0]:
        return None
    spans, _, it = got
    s = spans["iteration"]
    return 1e3 * (s["host_s"] - s["wait_s"]) / it
