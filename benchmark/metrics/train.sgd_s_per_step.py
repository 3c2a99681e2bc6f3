"""Seconds of the normaliser's update and the SGD passes a training step,
mean over the window's steps: from the synchronisation after the
rollout to the one at the next step's start (host clock)."""

from benchmark import readings


def read(ctx):
    return readings.mean_or_none(ctx.run.sgd_s)
