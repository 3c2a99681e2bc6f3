"""Small numeric constants on the device, copied from the host once.

A tensor made from host data inside a step (``x.new_tensor([...])``) is a
copy from pageable host memory at every call, which a CUDA graph cannot
capture; ``constant`` makes it once per dtype and device and reuses it.
Callers must not write into what it returns."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values: tuple, like: torch.Tensor) -> torch.Tensor:
    """``like.new_tensor(values)``, made once: ``values`` a tuple of
    numbers (nested tuples for more dimensions)."""
    return _constant(values, like.dtype, like.device)
