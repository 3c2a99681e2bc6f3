"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the full 700 W power limit)."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
              "fp16": 989e12}


def precision(dtype: torch.dtype) -> str:
    """The precision the matrix products of ``dtype`` parameters run in,
    read from PyTorch's flags as they stand."""
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.float16:
        return "fp16"
    if dtype == torch.float32:
        return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "fp32"
    raise ValueError(f"no published peak for {dtype}")


def least_seconds(nbytes: float, flops: float, peak: str = "fp32") -> float:
    """The least time the chip could take: bytes over the HBM bandwidth or
    operations over the peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOP_PER_S[peak])
