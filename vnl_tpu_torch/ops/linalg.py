"""SPD inverse by recursive Schur complements (PyTorch counterpart of
vnl_tpu/ops/linalg.py:20 inv_spd): all matrix products, log2(n) depth.
The plain position stage (ops/position.py) uses it, as the JAX package's
_position_reference does."""

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
