"""Percent of kernel D's roofline in the traced step: the least time of
the constraint systems' bytes (counts/constraints.py; a launch a substep
over the configuration's envs) over the device time of the kernel
``constraints_kernel``, summed from the trace's device operations."""

import re

from benchmark.counts import constraints, peaks, scene

KERNEL = re.compile(r"(?<![a-z_])constraints_kernel(?![a-z_])")


def read(ctx):
    tr = ctx.run.trace
    if tr is None or not ctx.run.traced_control_steps:
        return None
    device_s = sum(e - s for name, s, e in tr.device_ops
                   if KERNEL.search(name)) / 1e9
    if device_s <= 0:
        return None
    cfg = ctx.cell.config
    s = scene.shapes(cfg)
    launches = ctx.run.traced_control_steps * s["substeps"]
    cost = constraints.constraints_cost(cfg, s, cfg["ppo"]["num_envs"])
    return 100.0 * launches * peaks.least_seconds(*cost) / device_s
