"""Milliseconds of trial-cost evaluation (`solver.step._cost`) per GN
iteration in the span phase."""

SPAN = ("ba_tpu_torch.solver.step", "_cost")


def read(ctx):
    xs = ctx["spans"].get(SPAN) or []
    it = ctx["spans"]["iterations"]
    return 1e3 * sum(xs) / it if xs and it else None
