"""Milliseconds of device time of an sgd.update span, mean over the
window: the copy into the SGD-update graph's static minibatch, its replay
and the copy out (program spans, benchmark/recorded.py)."""

from benchmark import recorded


def read(ctx):
    return recorded.mean_device_ms(ctx, "sgd.update")
