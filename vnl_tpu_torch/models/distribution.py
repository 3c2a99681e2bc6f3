"""tanh-squashed diagonal Gaussian action distribution (PyTorch
counterpart of vnl_tpu/models/distribution.py NormalTanhDistribution)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _tanh_log_det(x):
    """log |d tanh(x)/dx| in the stable form 2 (log 2 - x - softplus(-2x))."""
    return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class NormalTanhDistribution:
    """tanh(Normal(loc, softplus(scale) + min_std))."""

    def __init__(self, event_size: int, min_std: float = 0.001,
                 var_scale: float = 1.0):
        self.param_size = 2 * event_size
        self.event_size = event_size
        self._min_std = min_std
        self._var_scale = var_scale

    def _loc_scale(self, logits):
        loc, scale = torch.chunk(logits, 2, dim=-1)
        return loc, (F.softplus(scale) + self._min_std) * self._var_scale

    def sample_no_postprocessing(self, logits, noise: Optional[torch.Tensor]
                                 = None, generator=None):
        """loc + scale * noise; the standard-normal noise is drawn from
        ``generator`` unless given."""
        loc, scale = self._loc_scale(logits)
        if noise is None:
            noise = torch.randn(loc.shape, generator=generator,
                                device=loc.device, dtype=loc.dtype)
        return loc + scale * noise

    def postprocess(self, raw_action):
        return torch.tanh(raw_action)

    def log_prob(self, logits, raw_action):
        loc, scale = self._loc_scale(logits)
        log_normal = (-0.5 * ((raw_action - loc) / scale) ** 2
                      - 0.5 * math.log(2.0 * math.pi) - torch.log(scale))
        return torch.sum(log_normal - _tanh_log_det(raw_action), -1)

    def entropy(self, logits, noise: Optional[torch.Tensor] = None,
                generator=None):
        loc, scale = self._loc_scale(logits)
        normal_entropy = 0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(scale)
        sample = self.sample_no_postprocessing(logits, noise, generator)
        return torch.sum(normal_entropy + _tanh_log_det(sample), -1)

    def mode(self, logits):
        loc, _ = self._loc_scale(logits)
        return torch.tanh(loc)
