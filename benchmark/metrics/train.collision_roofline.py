"""Percent of kernel E's roofline in the traced step: the least time of
the narrowphase's bytes (counts/collision.py; a launch a substep over the
configuration's envs) over the device time of the kernel
``collision_kernel``, summed from the trace's device operations.  None
where the trace holds no such kernel (a program whose narrowphase is
plain PyTorch)."""

import re

from benchmark.counts import collision, peaks, scene

KERNEL = re.compile(r"(?<![a-z_])collision_kernel(?![a-z_])")


def read(ctx):
    tr = ctx.run.trace
    if tr is None or not ctx.run.traced_control_steps:
        return None
    device_s = sum(e - s for name, s, e in tr.device_ops
                   if KERNEL.search(name)) / 1e9
    if device_s <= 0:
        return None
    cfg = ctx.cell.config
    launches = ctx.run.traced_control_steps * scene.shapes(cfg)["substeps"]
    cost = collision.collision_cost(cfg, cfg["ppo"]["num_envs"])
    return 100.0 * launches * peaks.least_seconds(*cost) / device_s
