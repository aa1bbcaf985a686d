"""Host reads of the solve path (`ba_tpu_torch.utils.sync.item.count`)
per GN iteration of the timed window."""


def read(ctx):
    w = ctx["window"]
    return w["syncs"] / w["iterations"] if w["iterations"] else None
