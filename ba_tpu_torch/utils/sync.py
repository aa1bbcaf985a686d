"""Device-to-host reads on the solve path, counted.

Python loops replace the reference's `lax.while_loop`/`cond`; every
data-dependent exit reads a scalar from the device, which waits for the
queue to drain.  All such reads of the solver go through `item`, so a run
can report its host syncs per iteration (`item.count`); `values` reads a
vector of them at once, counted the same way.  Each read is a
`host_read` span (`utils.timing`): the time the host waited on the card.
"""

from __future__ import annotations

from . import timing


def item(x):
    """`x.item()`, counted in `item.count`."""
    item.count += 1
    with timing.span("host_read", x):
        return x.item()


item.count = 0


def values(x):
    """`x.tolist()` of a 1-D tensor, counted as one read in `item.count`."""
    item.count += 1
    with timing.span("host_read", x):
        return x.tolist()
