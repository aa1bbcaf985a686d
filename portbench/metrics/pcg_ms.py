"""Milliseconds of one PCG reduced solve (`solver.cg.solve_reduced_cg`,
with the landmark back-substitution), between two synchronizes."""

from . import span_ms_per_call

SPAN = ("ba_tpu_torch.solver.cg", "solve_reduced_cg")


def read(ctx):
    return span_ms_per_call(ctx, SPAN)
