"""Kernel K10's share of its roofline: the bound of one call
(`rooflines/k10.py`) over the device time of one call in the profiled
phase, in %."""

from . import roofline_pct

ROOFLINE = "k10"


def read(ctx):
    return roofline_pct(ctx, ROOFLINE)
