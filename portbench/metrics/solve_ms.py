"""The timed window's wall time over the whole solves in it, in ms: each
solve runs from the same start and is closed by a synchronize."""


def read(ctx):
    w = ctx["window"]
    return 1e3 * w["elapsed_s"] / w["solves"]
