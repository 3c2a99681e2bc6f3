"""Running observation statistics (PyTorch counterpart of
vnl_tpu/training/running_statistics.py): a Welford-style streaming mean and
std.  The update reduces over all leading batch dims; with
``data_parallel`` it also sums the count, the batch sum and the variance
update over the ranks of the process group (the JAX package's psum), so
that every rank keeps the same statistics."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class RunningStatisticsState:
    count: torch.Tensor             # scalar
    mean: torch.Tensor              # feature-shaped
    summed_variance: torch.Tensor   # feature-shaped (M2)
    std: torch.Tensor               # feature-shaped


def init_state(shape, dtype=torch.float32,
               device="cuda") -> RunningStatisticsState:
    shape = tuple(shape)
    return RunningStatisticsState(
        count=torch.zeros((), dtype=torch.float32, device=device),
        mean=torch.zeros(shape, dtype=dtype, device=device),
        summed_variance=torch.zeros(shape, dtype=dtype, device=device),
        std=torch.ones(shape, dtype=dtype, device=device))


def update(state: RunningStatisticsState,
           batch: torch.Tensor) -> RunningStatisticsState:
    """Folds a batch of observations into the statistics (Chan's parallel
    update: the variance term pairs the old and the new mean).  With
    ``data_parallel`` the batch is this rank's share of the global batch."""
    batch_dims = tuple(range(batch.dim() - state.mean.dim()))
    batch_count = float(math.prod(batch.shape[:len(batch_dims)]))
    batch_sum = batch.sum(batch_dims)
    count = state.count + batch_count
    mean = (state.mean + batch_sum / count
            - state.mean * batch_count / count)
    var_update = ((batch - state.mean) * (batch - mean)).sum(batch_dims)
    summed_variance = state.summed_variance + var_update
    std = torch.sqrt(torch.clamp(summed_variance / count, min=0.0) + 1e-6)
    return RunningStatisticsState(count=count, mean=mean,
                                  summed_variance=summed_variance, std=std)


def normalize(batch: torch.Tensor, mean: torch.Tensor,
              std: torch.Tensor) -> torch.Tensor:
    return (batch - mean) / std


def denormalize(batch: torch.Tensor, mean: torch.Tensor,
                std: torch.Tensor) -> torch.Tensor:
    return batch * std + mean
