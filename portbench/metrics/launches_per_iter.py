"""Device kernels launched per GN iteration in the profiled phase."""


def read(ctx):
    t = ctx["trace"]
    return t["launches"] / t["iterations"] if t["iterations"] else None
