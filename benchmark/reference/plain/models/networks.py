"""Basic network building blocks (PyTorch counterpart of
vnl_tpu/models/networks.py)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn


def lecun_uniform_(weight: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
    """U(-sqrt(3 / fan_in), sqrt(3 / fan_in)) on an (out, in) weight."""
    bound = math.sqrt(3.0 / weight.shape[1])
    return nn.init.uniform_(weight, -bound, bound, generator=generator)


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """Flax's default Dense initialiser: a normal of variance 1 / fan_in
    truncated at two standard deviations (0.8796... is the standard
    deviation of that truncated unit normal)."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class MLP(nn.Module):
    """Plain MLP; layers are named hidden_0, hidden_1, ... as in the Flax
    parameter tree.  Kernels LeCun-uniform, biases zero."""

    def __init__(self, in_size: int, layer_sizes: Sequence[int],
                 activate_final: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.depth = len(layer_sizes)
        self.activate_final = activate_final
        for k, size in enumerate(layer_sizes):
            layer = nn.Linear(in_size, size)
            with torch.no_grad():
                lecun_uniform_(layer.weight, generator)
                layer.bias.zero_()
            setattr(self, f"hidden_{k}", layer)
            in_size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.depth):
            x = getattr(self, f"hidden_{k}")(x)
            if k != self.depth - 1 or self.activate_final:
                x = torch.relu(x)
        return x


def make_value_network(obs_size: int,
                       hidden_layer_sizes: Sequence[int] = (1024, 1024),
                       generator: Optional[torch.Generator] = None) -> MLP:
    """Value MLP with one output; PPOImitationNetworks.value_apply
    normalises the observation and squeezes the output."""
    return MLP(obs_size, list(hidden_layer_sizes) + [1], generator=generator)
