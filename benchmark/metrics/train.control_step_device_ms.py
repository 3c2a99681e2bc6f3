"""Milliseconds of device time of a rollout.control_step span, mean over
the window: one replay of the control-step graph (physics and policy) and
the copy of its transition (program spans, benchmark/recorded.py)."""

from benchmark import recorded


def read(ctx):
    return recorded.mean_device_ms(ctx, "rollout.control_step")
