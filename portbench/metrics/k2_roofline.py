"""Kernel K2's share of its roofline: the bound of one call
(`rooflines/k2.py`) over the device time of one call in the profiled
phase, in %."""

from . import roofline_pct

ROOFLINE = "k2"


def read(ctx):
    return roofline_pct(ctx, ROOFLINE)
