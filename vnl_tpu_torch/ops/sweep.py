"""Kernel C: batched SPD inverse by the symmetric sweep (counterpart of
vnl_tpu/ops/pallas_linalg.py: _sweep_kernel with its wrappers inv_spd_lanes
and inv_spd_fused).

``inv_spd_sweep(a)`` inverts contiguous float32 SPD matrices (..., n, n).
On a CUDA tensor it launches the hand-written kernel csrc/sweep.cu, one
block per matrix; on a CPU tensor it runs ``inv_spd_sweep_plain``, the same
Jacobi scaling, the same n snapshot-and-update steps and the same
symmetrisation as batched tensor operations.  There is no batch threshold
and no other inverse to fall back on: a build or launch failure raises.
The unfused position stage calls it as ``inv_spd_fused``
(physics/inertia.py invert_mass_matrix).
"""

from __future__ import annotations

import ctypes

import torch

from vnl_tpu_torch.ops import build, launch_counts

THREADS = 256
MAX_SMEM = 232448        # dynamic shared memory one block may ask for


def inv_spd_sweep_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C: (..., n, n) -> (..., n, n)."""
    n = a.shape[-1]
    s = torch.rsqrt(torch.diagonal(a, dim1=-2, dim2=-1))
    x = a * s[..., :, None] * s[..., None, :]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    for k in range(n):
        col = x[..., :, k].clone()          # snapshots: the update is not
        row = x[..., k, :].clone()          # bitwise symmetric
        dinv = 1.0 / x[..., k, k]
        v = col - eye[k]
        w = (row - eye[k]) * dinv[..., None]
        x = x - v[..., :, None] * w[..., None, :]
        x[..., k, k] -= 2.0                 # the rank-1 form over-counts by 2
    x = -x * s[..., :, None] * s[..., None, :]
    return 0.5 * (x + x.transpose(-1, -2))


def _check(a: torch.Tensor) -> None:
    if a.dtype != torch.float32 or a.dim() < 2 or \
            a.shape[-1] != a.shape[-2] or a.shape[-1] < 1 or \
            not a.is_contiguous():
        raise ValueError("kernel C takes contiguous float32 (..., n, n) "
                         f"matrices, got {a.dtype} {tuple(a.shape)}")


def resources(n: int) -> dict:
    """Registers per thread, local (spill) bytes, shared memory per block
    and resident blocks per SM of kernel C for n x n matrices."""
    return dict(build.resources("sweep", n, THREADS), threads=THREADS)


def _launch(a: torch.Tensor) -> torch.Tensor:
    _check(a)
    n = a.shape[-1]
    lib = build.load("sweep")
    lib.sweep_smem_bytes.restype = ctypes.c_size_t
    need = lib.sweep_smem_bytes(ctypes.c_int(n))
    if need > MAX_SMEM:
        raise ValueError(f"kernel C keeps one matrix in shared memory: n = "
                         f"{n} needs {need} bytes of {MAX_SMEM}")
    fn = lib.sweep_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(a)
    batch = a.numel() // (n * n)
    if batch:
        stream = torch.cuda.current_stream(a.device).cuda_stream
        with torch.cuda.device(a.device):
            build.check(fn(a.data_ptr(), out.data_ptr(), batch, n, THREADS,
                           stream), "kernel C (sweep)")
        launch_counts["sweep"] += 1
    return out


def inv_spd_sweep(a: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of SPD matrices: kernel C on a CUDA tensor, the
    plain version on a CPU tensor."""
    if a.is_cuda:
        return _launch(a)
    if a.device.type != "cpu":
        raise ValueError(f"no SPD sweep for device {a.device}")
    _check(a)
    return inv_spd_sweep_plain(a)


inv_spd_fused = inv_spd_sweep
