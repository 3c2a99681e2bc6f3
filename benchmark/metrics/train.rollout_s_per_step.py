"""Seconds of rollout a training step, mean over the window's steps: from
the synchronisation train() makes at a step's start to the one after its
rollout (host clock)."""

from benchmark import readings


def read(ctx):
    return readings.mean_or_none(ctx.run.rollout_s)
