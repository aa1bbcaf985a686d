"""Device-to-host reads on the solve path, counted.

Python loops replace the reference's `lax.while_loop`/`cond`; every
data-dependent exit reads a scalar from the device, which waits for the
queue to drain.  All such reads of the solver go through `item`, so a run
can report its host syncs per iteration (`item.count`); `values` reads a
vector of them at once, counted the same way.
"""

from __future__ import annotations


def item(x):
    """`x.item()`, counted in `item.count`."""
    item.count += 1
    return x.item()


item.count = 0


def values(x):
    """`x.tolist()` of a 1-D tensor, counted as one read in `item.count`."""
    item.count += 1
    return x.tolist()
