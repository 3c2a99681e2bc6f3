"""Kernel C: batched SPD inverse by the symmetric sweep (counterpart of
vnl_tpu/ops/pallas_linalg.py: _sweep_kernel with its wrappers inv_spd_lanes
and inv_spd_fused).

``inv_spd_sweep(a)`` inverts contiguous float32 SPD matrices (..., n, n).
On a CUDA tensor it launches the hand-written kernel csrc/sweep.cu by the
route ``route(n)`` picks: n <= 32 sweeps one matrix on one warp, lane s
holding column s, with no barrier; 32 < n <= 96 sweeps a register tile per
thread, two matrices a block, two pivots a barrier; 96 < n <= 238 keeps
one matrix in shared memory.  On a CPU tensor it runs
``inv_spd_sweep_plain``, the same Jacobi scaling, the same n
snapshot-and-update steps and the same symmetrisation as batched tensor
operations.  There is no batch threshold
and no other inverse to fall back on: a build or launch failure raises.
The unfused position stage calls it as ``inv_spd_fused``
(physics/inertia.py invert_mass_matrix).
"""

from __future__ import annotations

import torch


def _jacobi(a: torch.Tensor):
    s = torch.rsqrt(torch.diagonal(a, dim1=-2, dim2=-1))
    return s, a * s[..., :, None] * s[..., None, :]


def _pivot(x: torch.Tensor, k: int, eye: torch.Tensor) -> torch.Tensor:
    """One sweep step at pivot k, column and row as they were before it."""
    col = x[..., :, k].clone()          # snapshots: the update is not
    row = x[..., k, :].clone()          # bitwise symmetric
    dinv = 1.0 / x[..., k, k]
    v = col - eye[k]
    w = (row - eye[k]) * dinv[..., None]
    x = x - v[..., :, None] * w[..., None, :]
    x[..., k, k] -= 2.0                 # the rank-1 form over-counts by 2
    return x


def _finish(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    x = -x * s[..., :, None] * s[..., None, :]
    return 0.5 * (x + x.transpose(-1, -2))


def inv_spd_sweep_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C: (..., n, n) -> (..., n, n)."""
    n = a.shape[-1]
    s, x = _jacobi(a)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    for k in range(n):
        x = _pivot(x, k, eye)
    return _finish(x, s)


def inv_spd_sweep(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of SPD matrices by the sweep, in plain PyTorch
    on any device."""
    return inv_spd_sweep_plain(a)


inv_spd_fused = inv_spd_sweep
