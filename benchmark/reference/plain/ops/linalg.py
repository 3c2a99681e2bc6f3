"""Batched linear algebra on plain matrix products (PyTorch counterpart of
vnl_tpu/ops/linalg.py).

``inv_spd``: SPD inverse by recursive Schur complements, log2(n) depth; the
plain position stage (ops/position.py) uses it, as the JAX package's
_position_reference does.  ``refine_inv``: Newton-Schulz polish of a
carried inverse, which the unfused position stage runs on every substep of
a control step but the first (physics/inertia.py invert_mass_matrix).
``refine_inv_general``: the same polish without the symmetrisation, for the
implicit integrator's unsymmetric (M - h qDeriv).  ``inv_spd_ns``: the
Jacobi-scaled Newton-Schulz inverse, which nothing calls (as in the JAX
package)."""

from __future__ import annotations

import torch


def inv_spd(a: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., n, n) SPD matrices:
    [[A, B], [B^T, C]]^-1 with S = C - B^T A^-1 B."""
    n = a.shape[-1]
    if n == 1:
        return 1.0 / a
    if n == 2:
        a00, a01, a11 = a[..., 0, 0], a[..., 0, 1], a[..., 1, 1]
        inv_det = 1.0 / (a00 * a11 - a01 * a01)
        row0 = torch.stack([a11 * inv_det, -a01 * inv_det], -1)
        row1 = torch.stack([-a01 * inv_det, a00 * inv_det], -1)
        return torch.stack([row0, row1], -2)
    k = n // 2
    A, Bm, C = a[..., :k, :k], a[..., :k, k:], a[..., k:, k:]
    Ai = inv_spd(A)
    AiB = Ai @ Bm
    Si = inv_spd(C - Bm.transpose(-1, -2) @ AiB)
    TR = -AiB @ Si
    TL = Ai - TR @ AiB.transpose(-1, -2)
    out = torch.cat([torch.cat([TL, TR], -1),
                     torch.cat([TR.transpose(-1, -2), Si], -1)], -2)
    return 0.5 * (out + out.transpose(-1, -2))


def refine_inv(a: torch.Tensor, x0: torch.Tensor,
               iters: int = 2) -> torch.Tensor:
    """Newton-Schulz refinement X <- X (2I - A X) of an approximate inverse
    ``x0`` of (..., n, n) matrices ``a``, symmetrised at the end.  With the
    previous substep's inverse as the seed two iterations reach the fp32
    floor."""
    eye2 = 2.0 * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    x = x0
    for _ in range(iters):
        x = x @ (eye2 - a @ x)
    return 0.5 * (x + x.transpose(-1, -2))


def refine_inv_general(a: torch.Tensor, x0: torch.Tensor,
                       iters: int = 6) -> torch.Tensor:
    """Newton-Schulz refinement X <- X (2I - A X) of an approximate inverse
    of general (possibly unsymmetric) (..., n, n) matrices, not
    symmetrised; converges quadratically while ||I - A x0|| < 1."""
    eye2 = 2.0 * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    x = x0
    for _ in range(iters):
        x = x @ (eye2 - a @ x)
    return x
