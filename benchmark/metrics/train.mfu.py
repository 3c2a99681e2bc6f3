"""Percent of one chip's peak for the precision in force: the
networks' operations in the window (counts/networks.py) over its
seconds."""

from benchmark import readings


def read(ctx):
    return readings.train_mfu(ctx)
