"""Profiling hooks (PyTorch counterpart of vnl_tpu/utils/profiler.py): a
trace of the host and the device, and per-phase wall-clock accounting."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str = "logs/trace"):
    """Captures a torch.profiler trace of the CPU and, where there is one,
    the CUDA device; writes ``<log_dir>/<worker>.<time>.pt.trace.json``,
    which TensorBoard's profiler plugin and Chrome's trace viewer open."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield log_dir


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class PhaseTimer:
    """Per-phase wall-clock accounting (rollout vs SGD vs eval)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Times the block; with ``block_on`` (a tensor or a nest of them)
        it first waits for the CUDA devices those tensors live on, since
        PyTorch returns before the device finishes."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            for dev in {t.device for t in _tensors(block_on)}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {f"profile/{k}_ms": 1e3 * v / max(self.counts[k], 1)
                for k, v in self.totals.items()}
