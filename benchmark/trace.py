"""The device trace of a traced run: torch.profiler over one stretch of
the program's work, reduced to kernel intervals.  The device's busy time
is the union of the intervals of its kernels and copies (overlapping
streams count once); the idle gaps between them are labelled by the
host operation that was running at their middle."""

from __future__ import annotations

import collections
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import torch

# the port's hand-written kernels by group, every route of each
# (vnl_tpu_torch/csrc/*.cu), as profile_rollout.KERNEL_GROUPS names them
KERNEL_GROUPS = tuple(
    (group, re.compile(rf"(?<![a-z_]){names}_kernel(?![a-z_])"))
    for group, names in (("position", "position(_warp)?"),
                         ("cg", "cg(_wide)?"),
                         ("sweep", "sweep(_tile|_warp)?")))
NCCL = re.compile(r"nccl", re.IGNORECASE)
COPY = re.compile(r"^mem(cpy|set)", re.IGNORECASE)


def group_of(name: str) -> str:
    """The group of a device operation: position, cg, sweep (the
    hand-written kernels A, B and C), nccl, copy (copies and fills), or
    other (the plain-torch kernels)."""
    for group, pattern in KERNEL_GROUPS:
        if pattern.search(name):
            return group
    if NCCL.search(name):
        return "nccl"
    return "copy" if COPY.search(name) else "other"


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


@dataclasses.dataclass
class Trace:
    """Device operations (name, start ns, end ns) and host operations
    likewise, cut to the traced window, and the window's length."""

    device_ops: List[Tuple[str, int, int]]
    host_ops: List[Tuple[str, int, int]]
    window_s: float

    def busy_intervals(self) -> List[Tuple[int, int]]:
        spans = sorted((s, e) for _, s, e in self.device_ops if e > s)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def group_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.Counter()
        for name, s, e in self.device_ops:
            out[group_of(name)] += (e - s) / 1e9
        return dict(out)

    def top_device_ops(self, n: int = 10) -> List[List]:
        by_name: Dict[str, float] = collections.Counter()
        for name, s, e in self.device_ops:
            by_name[name] += (e - s) / 1e9
        return [[k, v] for k, v in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest gaps between busy intervals, each labelled by
        the innermost host operation around its middle ("host idle" where
        none was running)."""
        busy = self.busy_intervals()
        gaps = sorted(((b[0] - a[1], a[1], b[0])
                       for a, b in zip(busy, busy[1:]) if b[0] > a[1]),
                      reverse=True)[:n]
        out = []
        for length, s, e in gaps:
            mid = (s + e) // 2
            around = [(he - hs, name) for name, hs, he in self.host_ops
                      if hs <= mid <= he]
            label = min(around)[1] if around else "host idle"
            out.append([label, length / 1e9])
        return out


MARK = "benchmark.traced_window"


class Tracer:
    """torch.profiler around a stretch of work.  The profiler starts
    before the stretch (``start``), so that its own warm-up falls outside;
    ``mark`` and ``stop`` bound the traced window with a host annotation,
    and only the operations inside it are kept.  The caller synchronises
    the device before ``mark`` and before ``stop``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._mark = None
        self.trace: Optional[Trace] = None

    def start(self) -> None:
        self._prof.start()

    def mark(self) -> None:
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()

    def stop(self) -> None:
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        device, host, window = [], [], None
        for ev in self._prof.profiler.kineto_results.events():
            s = _ns(ev, "start")
            e = s + _ns(ev, "duration")
            if ev.name() == MARK:
                # the annotation has a host event and a device-side one
                # spanning the window; neither is work
                if ev.device_type() != torch.autograd.DeviceType.CUDA:
                    window = (s, e)
            elif ev.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((ev.name(), s, e))
            else:
                host.append((ev.name(), s, e))
        s0, e0 = window
        self.trace = Trace(
            [(n, max(s, s0), min(e, e0)) for n, s, e in device
             if e > s0 and s < e0],
            [(n, s, e) for n, s, e in host if e > s0 and s < e0],
            (e0 - s0) / 1e9)
