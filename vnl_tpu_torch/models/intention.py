"""Latent-intention actor network (PyTorch counterpart of
vnl_tpu/models/intention.py).

A trajectory encoder compresses the reference-feature window into a
Gaussian posterior over a latent intention; one reparameterised draw,
concatenated with the normalised observation, drives a decoder that emits
the action distribution's parameters.  Hidden layers are Linear -> ReLU ->
LayerNorm (eps 1e-6, Flax's default); the trajectory is not normalised.
Module names follow the Flax parameter tree (encoder.proj_0, ...), so the
weights of a JAX checkpoint map one to one (compat.policy_from_numpy).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vnl_tpu_torch.training.running_statistics import normalize


class NormedStack(nn.Module):
    """Linear -> relu -> LayerNorm, repeated."""

    def __init__(self, in_width: int, widths: Sequence[int]):
        super().__init__()
        self.depth = len(widths)
        for k, w in enumerate(widths):
            setattr(self, f"proj_{k}", nn.Linear(in_width, w))
            setattr(self, f"norm_{k}", nn.LayerNorm(w, eps=1e-6))
            in_width = w

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for k in range(self.depth):
            h = getattr(self, f"norm_{k}")(
                torch.relu(getattr(self, f"proj_{k}")(h)))
        return h


class IntentionPolicy(nn.Module):
    """(traj, obs, latent noise) -> (dist params, posterior mean,
    posterior logvar).  Holds the observation normaliser's mean and std as
    buffers."""

    def __init__(self, traj_size: int, obs_size: int,
                 encoder_widths: Sequence[int], decoder_widths: Sequence[int],
                 latent_width: int, out_width: int):
        super().__init__()
        self.latent_width = latent_width
        self.encoder = NormedStack(traj_size, encoder_widths)
        self.post_mean = nn.Linear(encoder_widths[-1], latent_width)
        self.post_logvar = nn.Linear(encoder_widths[-1], latent_width)
        self.decoder = NormedStack(latent_width + obs_size, decoder_widths)
        self.action_head = nn.Linear(decoder_widths[-1], out_width)
        self.register_buffer("obs_mean", torch.zeros(obs_size))
        self.register_buffer("obs_std", torch.ones(obs_size))

    def forward(self, traj: torch.Tensor, obs: torch.Tensor,
                latent_noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``latent_noise`` (B, latent) is a standard-normal draw; drawn from
        ``generator`` when not given."""
        h = self.encoder(traj)
        post_mean = self.post_mean(h)
        post_logvar = self.post_logvar(h)
        if latent_noise is None:
            latent_noise = torch.randn(post_mean.shape, generator=generator,
                                       device=post_mean.device,
                                       dtype=post_mean.dtype)
        intention = post_mean + latent_noise * torch.exp(0.5 * post_logvar)
        obs = normalize(obs, self.obs_mean, self.obs_std)
        g = self.decoder(torch.cat([intention, obs], -1))
        return self.action_head(g), post_mean, post_logvar
