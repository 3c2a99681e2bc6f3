"""Seconds of the program's graph.capture spans (a CUDA graph's capture
and instantiation) that ended before the window opened: the captures'
part of setup_s (benchmark/recorded.py)."""

from benchmark import recorded


def read(ctx):
    return recorded.capture_s(ctx)
