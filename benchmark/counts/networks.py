"""Operations of the intention-PPO networks, counted from the widths in a
configuration file: two operations per weight of every linear layer and
sample (the matrix products; biases, ReLUs and LayerNorms are under 1% at
these widths and are left out)."""

from __future__ import annotations

from typing import Dict, Sequence


def _mlp(widths: Sequence[int]) -> int:
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def policy_flops(net: Dict, sizes: Dict) -> int:
    """One forward of the intention policy for one sample: the encoder on
    the reference window, the posterior's mean and log-variance, the
    decoder on the latent and the observation, the action head."""
    enc = [sizes["traj_size"]] + list(net["encoder_layer_sizes"])
    dec = ([net["intention_latent_size"] + sizes["obs_size"]]
           + list(net["decoder_layer_sizes"]) + [2 * sizes["action_size"]])
    return (_mlp(enc) + 2 * 2 * enc[-1] * net["intention_latent_size"]
            + _mlp(dec))


def value_flops(net: Dict, sizes: Dict) -> int:
    """One forward of the value network for one sample."""
    return _mlp([sizes["obs_size"]] + list(net["value_hidden_layer_sizes"])
                + [1])


def training_step_flops(net: Dict, sizes: Dict, ppo: Dict) -> int:
    """One training step: a policy forward per env step of the rollout,
    and forward and backward (three forwards) of policy and value for
    every sample of every SGD pass."""
    samples = (ppo["batch_size"] * ppo["num_minibatches"]
               * ppo["unroll_length"])
    p, v = policy_flops(net, sizes), value_flops(net, sizes)
    return samples * p + ppo["num_updates_per_batch"] * samples * 3 * (p + v)

