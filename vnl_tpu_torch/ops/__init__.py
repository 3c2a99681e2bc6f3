"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (ops/position.py: kernel A, the fused position stage; ops/cg.py:
kernel B, the CG contact solve; ops/sweep.py: kernel C, the SPD sweep
inverse of the unfused position stage; ops/constraints.py: kernel D, the
limit and contact constraint system of a substep as kernel B takes it).

``launch_counts`` counts kernel launches by name; a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.  Kernel B's launches on its widest route,
``cg_kernel<0>``, are also counted on their own, as "cg_widest".

Under a CUDA graph (utils/graphs.py) the wrappers' Python runs once, at
the capture, which launches nothing; ``ReplayCounts`` takes the capture's
counts back and adds them once for every replay, so the counts are those
of the eager run."""

import collections
import contextlib
from typing import MutableMapping

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
