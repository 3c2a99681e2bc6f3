"""The card's launch speed, read by the harness itself.

An H100 runs a fresh process's CUDA-graph kernels at one of two speeds: a
process may start with 0.2-0.35 us more a kernel node (1.19-1.23 us a
node of tiny kernels against 1.01-1.02) and turn fast once, after 10 s
to over 56 s, at no clock, power or P-state change nvidia-smi shows.
A training step at 128 envs (about 630,000 graph nodes) then takes 16%
longer.  The harness replays a graph of its own, 1,000 tiny kernels on a
buffer of its own, times it with CUDA events between training steps, and
opens the window once it reads fast (or at ``WAIT_CAP_S`` after process
start, where the run goes on at the speed it has)."""

from __future__ import annotations

from typing import Optional

import torch

NODES = 1000
REPLAYS = 5
FAST_US_PER_NODE = 1.10      # between the two speeds' readings
WAIT_CAP_S = 150.0


class LaunchProbe:
    """Microseconds a node of a graph of ``NODES`` tiny kernels, on the
    current CUDA device (None on the CPU)."""

    def __init__(self, device):
        self._cuda = torch.device(device).type == "cuda"
        self._graph = None
        self._buf = None

    def _capture(self) -> None:
        self._buf = torch.zeros(128, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._buf.add_(1.0)
        torch.cuda.current_stream().wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            for _ in range(NODES):
                self._buf.add_(1.0)
        torch.cuda.synchronize()

    def us_per_node(self) -> Optional[float]:
        if not self._cuda:
            return None
        if self._graph is None:
            self._capture()
        self._graph.replay()             # the first replay uploads
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPLAYS):
            self._graph.replay()
        end.record()
        end.synchronize()
        return 1e3 * start.elapsed_time(end) / (REPLAYS * NODES)

    def fast(self) -> bool:
        """Whether the card reads fast (always on the CPU)."""
        us = self.us_per_node()
        return us is None or us < FAST_US_PER_NODE
