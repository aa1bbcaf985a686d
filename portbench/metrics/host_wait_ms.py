"""Host milliseconds per GN iteration inside the program's `host_read`
spans (`ba_tpu_torch.utils.sync.item` / `values`): the time the host
waited on the card, in the profiled phase.  The program's spans record
while the profiler does (`ba_tpu_torch.utils.timing`)."""


def program_summary(ctx):
    """(spans, counters, GN iterations) of the profiled phase from the
    program's own store, or None where the program keeps none or the
    phase ran no iteration."""
    from ba_tpu_torch.utils import timing

    summary = getattr(timing, "summary", None)
    it = ctx["trace"]["iterations"]
    if summary is None or not it:
        return None
    s = summary()
    return s["spans"], s["counters"], it


def read(ctx):
    got = program_summary(ctx)
    if got is None or "host_read" not in got[0]:
        return None
    spans, _, it = got
    return 1e3 * spans["host_read"]["host_s"] / it
