"""The share of the PCG's Schur products that moved x: 100 times the
program's counter `pcg.iterations` (a device count of the live
iterations) over `pcg.products` (products launched, the masked ones
after convergence included), in the profiled phase."""

from .host_wait_ms import program_summary


def read(ctx):
    got = program_summary(ctx)
    c = got[1] if got is not None else {}
    if not c.get("pcg.products"):
        return None
    return 100.0 * c["pcg.iterations"] / c["pcg.products"]
