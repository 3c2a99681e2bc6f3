"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (ops/position.py: kernel A, ops/cg.py: kernel B).

``launch_counts`` counts kernel launches by name; a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels."""

import collections

launch_counts = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()
