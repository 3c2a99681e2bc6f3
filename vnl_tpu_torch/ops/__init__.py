"""Hand-written CUDA kernels of the port, each in ``ops/<name>.py`` beside
its plain PyTorch version, with its one entry in ``KERNELS``: its source,
launch counter, label, device-op pattern, graph part and nvcc flags,
from which the build (ops/build.py, which also holds what the wrappers
share), the profiling tools and chip_smoke.py take them.

``launch_counts`` counts kernel launches by name; ``build.launch`` adds
one for each launch and nothing else does, so a run can show that the main
path went through the kernels.  Kernel B's launches on its widest route,
``cg_kernel<0>``, are also counted on their own, as "cg_widest".

Under a CUDA graph (utils/graphs.py) the wrappers' Python runs once, at
the capture, which launches nothing; ``ReplayCounts`` takes the capture's
counts back and adds them once for every replay, so the counts are those
of the eager run."""

import collections
import contextlib
import re
from typing import MutableMapping, NamedTuple, Optional, Tuple


class Kernel(NamedTuple):
    """A hand-written kernel.  ``name``: its source csrc/<name>.cu, its
    library and its key in ``launch_counts``; ``letter``: kernel A to F
    in the docs and the errors; ``routes``: the pattern of
    its ``__global__`` functions' names before ``_kernel``, by which a
    trace's device ops are grouped; ``part``: the part of the graph
    (utils/profiler.py ``part``) that launches it: a stage of the control
    step on the fused paths, or the SGD update's ``gae`` (kernel C has
    none); ``flags``: nvcc flags of its own."""

    name: str
    letter: str
    routes: str
    part: Optional[str]
    flags: Tuple[str, ...] = ()

    @property
    def label(self) -> str:
        return f"kernel {self.letter} ({self.name})"

    @property
    def source(self) -> str:
        return f"{self.name}.cu"

    @property
    def pattern(self) -> re.Pattern:
        """Its routes' names, demangled or not."""
        return re.compile(rf"(?<![a-z_]){self.routes}_kernel(?![a-z_])")


KERNELS = {k.name: k for k in (
    Kernel("position", "A", "position(_warp)?", "position"),
    Kernel("cg", "B", "cg(_wide)?", "solve"),
    Kernel("sweep", "C", "sweep(_tile|_warp)?", None),
    Kernel("constraints", "D", "constraints", "constraints"),
    # kernels E and F round each operation on their own, as their plain
    # versions' separate PyTorch operations do
    Kernel("collision", "E", "collision", "collision", ("-fmad=false",)),
    Kernel("gae", "F", "gae", "gae", ("-fmad=false",)))}

launch_counts = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()


class ReplayCounts:
    """The counts of a captured graph, for each of ``counters`` (mappings
    of name to count; ``launch_counts`` by default)."""

    def __init__(self, *counters: MutableMapping[str, int]):
        self._counters = counters or (launch_counts,)
        self.deltas = [collections.Counter() for _ in self._counters]

    @contextlib.contextmanager
    def record(self):
        """Around the capture: what the block counts goes into ``deltas``,
        and the counters are left as they were before it."""
        before = [dict(c) for c in self._counters]
        try:
            yield self.deltas
        finally:
            for c, b, d in zip(self._counters, before, self.deltas):
                d.update({k: v - b.get(k, 0) for k, v in c.items()
                          if v != b.get(k, 0)})
                c.clear()
                c.update(b)

    def replayed(self) -> None:
        """After a replay: adds the recorded counts once."""
        for c, d in zip(self._counters, self.deltas):
            for k, v in d.items():
                c[k] = c.get(k, 0) + v
