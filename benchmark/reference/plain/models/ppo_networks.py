"""Agent network bundle and policy construction for intention-PPO
(PyTorch counterpart of vnl_tpu/models/ppo_networks.py)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from benchmark.reference.plain.models.distribution import NormalTanhDistribution
from benchmark.reference.plain.models.intention import IntentionPolicy
from benchmark.reference.plain.models.networks import MLP, make_value_network


class PPOImitationNetworks(nn.Module):
    """Actor (intention policy), critic and the tanh-Gaussian action
    distribution.  The observation normaliser lives once, in the policy's
    ``obs_mean`` / ``obs_std`` buffers; the critic reads the same buffers.
    At mean 0 and std 1 (their initial values) it is the identity."""

    def __init__(self, policy: IntentionPolicy, value: MLP,
                 dist: NormalTanhDistribution):
        super().__init__()
        self.policy = policy
        self.value = value
        self.parametric_action_distribution = dist

    def value_apply(self, obs: torch.Tensor) -> torch.Tensor:
        """Critic on raw observations: (..., obs) -> (...)."""
        obs = (obs - self.policy.obs_mean) / self.policy.obs_std
        return self.value(obs).squeeze(-1)

    def set_normalizer(self, state) -> None:
        """Makes a RunningStatisticsState the networks' normaliser."""
        self.policy.obs_mean.copy_(state.mean)
        self.policy.obs_std.copy_(state.std)


def make_intention_ppo_networks(
    traj_size: int,
    observation_size: int,
    action_size: int,
    intention_latent_size: int = 64,
    encoder_layer_sizes: Sequence[int] = (1024, 1024),
    decoder_layer_sizes: Sequence[int] = (1024, 1024),
    value_hidden_layer_sizes: Sequence[int] = (1024, 1024),
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> PPOImitationNetworks:
    """Assembles and initialises the networks as the JAX package does:
    the policy's layers LeCun-normal (Flax's Dense default), the critic's
    LeCun-uniform, biases zero, LayerNorm at scale 1.  The draws come from
    ``generator`` (a CPU generator: the weights are made on the CPU and
    then moved), so only the distributions match the JAX package's, not
    the numbers."""
    dist = NormalTanhDistribution(event_size=action_size)
    policy = IntentionPolicy(
        traj_size=traj_size, obs_size=observation_size,
        encoder_widths=tuple(encoder_layer_sizes),
        decoder_widths=tuple(decoder_layer_sizes),
        latent_width=intention_latent_size, out_width=dist.param_size)
    policy.reset_parameters(generator)
    value = make_value_network(observation_size, value_hidden_layer_sizes,
                               generator)
    return PPOImitationNetworks(policy, value, dist).to(device)
