"""Env steps of training completed in the window over the window's
seconds (host clock)."""

from benchmark import readings


def read(ctx):
    return readings.rate(ctx)
