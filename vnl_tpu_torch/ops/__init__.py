"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (ops/position.py: kernel A, the fused position stage; ops/cg.py:
kernel B, the CG contact solve; ops/sweep.py: kernel C, the SPD sweep
inverse of the unfused position stage).

``launch_counts`` counts kernel launches by name; a wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.  Kernel B's launches on its widest route,
``cg_kernel<0>``, are also counted on their own, as "cg_widest"."""

import collections

launch_counts = collections.Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()
