"""Seconds from process start to the first instant of the window:
imports, kernel load, env build, train()'s set-up, the first evaluation
with its capture and the warm-up steps (host clock)."""


def read(ctx):
    return ctx.run.setup_parts.get("warm_up")
