"""PCG iterations per build (`PcgResult.iterations` of each
`solver.cg.pcg_solve` call in the span phase, a device count read after
the phase)."""

TAP = ("ba_tpu_torch.solver.cg", "pcg_solve")


def tap(args, kwargs, out):
    return out.iterations


def read(ctx):
    xs = [int(x) for x in ctx["taps"].get("pcg_iters") or []]
    return sum(xs) / len(xs) if xs else None
