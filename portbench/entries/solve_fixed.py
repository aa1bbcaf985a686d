"""`step.solve_fixed`: the mix's `iterations` of Gauss-Newton over the
prepared problem, with the cost after each."""

from __future__ import annotations

from .. import program
from ..program import (Batch as setup, numbers, outputs_of,  # noqa: F401
                       reference)


def solve(prog):
    from ba_tpu_torch.solver import step

    n = prog.mix["iterations"]
    out, costs, _ = step.solve_fixed(prog.prepared, prog.cfg, prog.use_imu, n)
    res = dict(costs=costs, **program.states(out))
    program.sync(prog.device)
    return res, n
