"""Milliseconds of one build (`solver.cg.assemble_blocks`: residuals,
robust weights, the segmented sums, the preconditioner), each call between
two synchronizes in the span phase."""

from . import span_ms_per_call

SPAN = ("ba_tpu_torch.solver.cg", "assemble_blocks")


def read(ctx):
    return span_ms_per_call(ctx, SPAN)
