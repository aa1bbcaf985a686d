"""Milliseconds of one dense fleet solve
(`solver.banded.solve_reduced_fleet_dense`: K10, the batched Cholesky and
its solves, the back-substitution), between two synchronizes."""

from . import span_ms_per_call

SPAN = ("ba_tpu_torch.solver.banded", "solve_reduced_fleet_dense")


def read(ctx):
    return span_ms_per_call(ctx, SPAN)
