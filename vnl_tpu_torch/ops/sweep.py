"""Kernel C: batched SPD inverse by the symmetric sweep (counterpart of
vnl_tpu/ops/pallas_linalg.py: _sweep_kernel with its wrappers inv_spd_lanes
and inv_spd_fused, here one function, ``inv_spd_sweep``).

``inv_spd_sweep(a)`` inverts contiguous float32 SPD matrices (..., n, n).
On a CUDA tensor it launches the hand-written kernel csrc/sweep.cu by the
route ``route(n)`` picks: n <= 32 sweeps one matrix on one warp, lane s
holding column s, with no barrier; 32 < n <= 96 sweeps a register tile per
thread, two matrices a block, two pivots a barrier; 96 < n <= 238 keeps
one matrix in shared memory.  On a CPU tensor it runs
``inv_spd_sweep_plain``, the same Jacobi scaling, the same n
snapshot-and-update steps and the same symmetrisation as batched tensor
operations, or the plain inverse its caller names.  There is no batch
threshold and no other inverse to fall back on: a build or launch failure
raises.  The unfused position stage (physics/inertia.py crb) and Newton's
H^-1 (physics/solver.py inv_spd) call it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from vnl_tpu_torch.ops import build

WARPS = 8            # warps that sweep one matrix on the register route
# The routes the kernel source instantiates, as (TR, TC).  TC = 1 is the
# one-warp route: lane s holds column s, TR = T rows of it, so it covers
# n <= T.  The others are register tiles: thread (warp, lane) of a matrix
# owns TR of its rows, in pairs (two pivots a barrier need both rows of a
# pair in one warp, so TR is even), and the columns lane + 32 * j, j < TC,
# so a tile covers n <= min(WARPS * TR, 32 * TC).  The next tile, (16, 4),
# would keep 64 entries and 20 pivot operands in a thread, more than the
# 64 registers of two blocks of 512 threads per SM.
WARP_TILES = ((16, 1), (32, 1))
TILE_SHAPES = WARP_TILES + ((8, 2), (10, 3), (12, 3))
WARP_MATS = 4        # matrices (warps) a block on the one-warp route: the
                     # source's kWarpMats
SHARED_THREADS = 256  # the shared-memory route: one matrix a block
MAX_SMEM = 232448    # dynamic shared memory one block may ask for


def shared_smem_bytes(n: int) -> int:
    """Shared memory of the shared-memory route: the matrix, its scales and
    two snapshot buffers of a column and a row."""
    return 4 * (n * n + 5 * n)


MAX_N = max(n for n in range(1, 512) if shared_smem_bytes(n) <= MAX_SMEM)


class Route(NamedTuple):
    kind: str                     # "warp", "register" or "shared"
    tile: Tuple[int, int]         # (TR, TC); (0, 0) on the shared route


def route(n: int) -> Route:
    """The route of kernel C for n x n matrices: the one-warp route of the
    smallest T >= n up to 32, else the smallest register tile that covers
    n, else the shared-memory route up to MAX_N (238); chosen by n alone.
    ValueError beyond."""
    if n < 1 or n > MAX_N:
        raise ValueError(f"kernel C inverts 1 <= n <= {MAX_N} (one matrix "
                         f"must fit {MAX_SMEM} bytes of shared memory), "
                         f"got n = {n}")
    for t, _ in WARP_TILES:
        if t >= n:
            return Route("warp", (t, 1))
    for tr, tc in TILE_SHAPES[len(WARP_TILES):]:
        if WARPS * tr >= n and 32 * tc >= n:
            return Route("register", (tr, tc))
    return Route("shared", (0, 0))


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


def inv_spd_sweep_pairs_plain(a: torch.Tensor) -> torch.Tensor:
    """The two-pivot form of the sweep, as the register route runs it, in
    plain PyTorch: pivots (k, k + 1) in one step A <- A - V P^-1 W with
    V = A[:, K] - E_K, W = A[K, :] - E_K^T and P = A[K, K], then both pivot
    entries minus 2; an odd n ends on a single pivot.  Equals
    ``inv_spd_sweep_plain`` up to rounding; nothing on the main path calls
    it, it shows the kernel's algebra on the CPU."""
    n = a.shape[-1]
    s, x = _jacobi(a)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    for k in range(0, n - 1, 2):
        v = x[..., :, k:k + 2] - eye[:, k:k + 2]          # (..., n, 2)
        w = x[..., k:k + 2, :] - eye[k:k + 2, :]          # (..., 2, n)
        p00, p01 = x[..., k, k], x[..., k, k + 1]
        p10, p11 = x[..., k + 1, k], x[..., k + 1, k + 1]
        idet = 1.0 / (p00 * p11 - p01 * p10)
        w0 = (p11 * idet)[..., None] * w[..., 0, :] - \
            (p01 * idet)[..., None] * w[..., 1, :]
        w1 = (p00 * idet)[..., None] * w[..., 1, :] - \
            (p10 * idet)[..., None] * w[..., 0, :]
        x = x - v[..., :, 0, None] * w0[..., None, :] \
            - v[..., :, 1, None] * w1[..., None, :]
        x[..., k, k] -= 2.0
        x[..., k + 1, k + 1] -= 2.0
    if n % 2:
        x = _pivot(x, n - 1, eye)
    return _finish(x, s)


def _check(a: torch.Tensor) -> None:
    """Kernel C's input: contiguous float32 (..., n, n)."""
    n = a.shape[-1] if a.dim() else 0
    build.check_inputs("sweep", a.device, a.shape[:-2], ("a", a, (n, n)))


def resources(n: int) -> dict:
    """Registers per thread, local (spill) bytes, shared memory per block
    and resident blocks per SM of kernel C for n x n matrices, with its
    route."""
    r = route(n)
    threads = dict(shared=SHARED_THREADS, warp=32 * WARP_MATS,
                   register=2 * WARPS * 32)[r.kind]
    return dict(build.resources("sweep", n, *r.tile),
                threads=threads, route=r.kind, tile=list(r.tile))


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 4


def _launch(a: torch.Tensor, skip: int = 0) -> torch.Tensor:
    """Launches kernel C on ``a`` by its route.  ``skip`` (profiling only;
    the result is then wrong): bit 0 leaves out the pivot loop, bit 1 the
    scaling, unscaling and symmetrisation."""
    _check(a)
    n = a.shape[-1]
    tr, tc = route(n).tile
    out = torch.empty_like(a)
    batch = a.numel() // (n * n)
    if batch:
        build.launch("sweep", _ARGTYPES, a.device, a.data_ptr(),
                      out.data_ptr(), batch, n, tr, tc, skip=skip)
    return out


def inv_spd_sweep(a: torch.Tensor, plain=None) -> torch.Tensor:
    """Inverse of a batch of SPD matrices: kernel C on a CUDA tensor;
    elsewhere ``plain(a)``, by default the sweep's own plain version,
    which takes kernel C's inputs alone."""
    if a.is_cuda:
        return _launch(a)
    if plain is None:
        _check(a)
        plain = inv_spd_sweep_plain
    return plain(a)
