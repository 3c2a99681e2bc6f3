"""Percent of kernel A's roofline in the traced step: the least time of
the position stage's work (counts/kernels.py) over the device time of
kernel A's group."""

from benchmark import readings


def read(ctx):
    return readings.position_roofline(ctx)
