"""Percent of kernel B's roofline in the traced step: the least time of
the constraint solves' work (counts/kernels.py) over the device time of
kernel B's group."""

from benchmark import readings


def read(ctx):
    return readings.cg_roofline(ctx)
