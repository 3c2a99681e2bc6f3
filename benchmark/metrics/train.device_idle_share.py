"""Percent of the window's wall time, from its second training step's
train.step span's start to its last one's end, that no device span of the
program covers: the device waits on the host (program spans, read by
benchmark/recorded.py)."""

from benchmark import recorded


def read(ctx):
    return recorded.device_idle_share(ctx)
