"""What a metric reader (``metrics/<name>.py``) reads: the run the loop
handed back, the cell, and helpers that turn traces and counts into the
metrics' units.  A reader returns None where the run gave it nothing to
read, and the harness then leaves the metric out of the line."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, List, Optional

from benchmark import loops, spec
from benchmark.counts import kernels, networks, peaks, scene


@dataclasses.dataclass
class Context:
    run: loops.Run
    cell: spec.Cell


def mean_or_none(values: List[float]) -> Optional[float]:
    return statistics.fmean(values) if values else None


def rate(ctx: Context) -> Optional[float]:
    if ctx.run.window_s <= 0:
        return None
    return ctx.run.env_steps / ctx.run.window_s


def kernel_roofline(ctx: Context, group: str,
                    cost: Callable) -> Optional[float]:
    """Percent: the least time of the traced control steps' work for a
    kernel (its count from the scene's shapes, every substep one launch
    over the configuration's envs) over the device time of that kernel's
    group."""
    tr = ctx.run.trace
    if tr is None or not ctx.run.traced_control_steps:
        return None
    device_s = tr.group_seconds().get(group, 0.0)
    if device_s <= 0:
        return None
    s = scene.shapes(ctx.cell.config)
    launches = ctx.run.traced_control_steps * s["substeps"]
    envs = ctx.cell.config["ppo"]["num_envs"]
    least = launches * peaks.least_seconds(*cost(s, envs))
    return 100.0 * least / device_s


def position_roofline(ctx: Context) -> Optional[float]:
    return kernel_roofline(ctx, "position", kernels.position_cost)


def cg_roofline(ctx: Context) -> Optional[float]:
    return kernel_roofline(ctx, "cg", kernels.cg_cost)


def peak_mem_gib(ctx: Context) -> Optional[float]:
    if not ctx.run.window_peak_bytes:
        return None
    return ctx.run.window_peak_bytes / 2 ** 30


def train_mfu(ctx: Context) -> Optional[float]:
    """Percent: the networks' operations in the window's training steps
    over its seconds over the chip's peak for the precision in force."""
    if ctx.run.window_s <= 0:
        return None
    cfg = ctx.cell.config
    flops = ctx.run.window_steps * networks.training_step_flops(
        cfg["networks"], cfg["sizes"], cfg["ppo"])
    peak = peaks.FLOP_PER_S[ctx.run.precision]
    return 100.0 * flops / ctx.run.window_s / peak
