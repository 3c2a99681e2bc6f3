"""Observation normalisation (PyTorch counterpart of
vnl_tpu/training/running_statistics.py:67 normalize).  The streaming update
comes with the learner, in a later slice."""

from __future__ import annotations

import torch


def normalize(batch: torch.Tensor, mean: torch.Tensor,
              std: torch.Tensor) -> torch.Tensor:
    return (batch - mean) / std

