"""Policy construction for intention-PPO (PyTorch counterpart of
vnl_tpu/models/ppo_networks.py:33 make_inference_fn)."""

from __future__ import annotations

from typing import Optional

import torch

from vnl_tpu_torch.models.distribution import NormalTanhDistribution
from vnl_tpu_torch.models.intention import IntentionPolicy


def make_inference_fn(policy: IntentionPolicy,
                      dist: Optional[NormalTanhDistribution] = None):
    """Returns make_policy(deterministic) -> policy_fn(traj, obs, generator,
    latent_noise=None, action_noise=None, uniform=None).

    The sampling policy returns the tanh action and the extras the PPO loss
    reads: the behaviour log-prob, the pre-tanh action, the distribution
    parameters, and the log-prob of a uniform action (a collapse
    diagnostic).  Noise not given is drawn from ``generator``."""
    if dist is None:
        dist = NormalTanhDistribution(policy.action_head.out_features // 2)

    def make_policy(deterministic: bool = False):

        @torch.no_grad()
        def mode_policy(traj, obs, generator=None, latent_noise=None):
            dist_params, _, _ = policy(traj, obs, latent_noise, generator)
            return dist.mode(dist_params), {}

        @torch.no_grad()
        def sampling_policy(traj, obs, generator=None, latent_noise=None,
                            action_noise=None, uniform=None):
            dist_params, _, _ = policy(traj, obs, latent_noise, generator)
            pre_tanh = dist.sample_no_postprocessing(dist_params, action_noise,
                                                     generator)
            if uniform is None:
                uniform = 2.0 * torch.rand(pre_tanh.shape, generator=generator,
                                           device=pre_tanh.device) - 1.0
            extras = {
                "log_prob": dist.log_prob(dist_params, pre_tanh),
                "rand_log_prob": dist.log_prob(dist_params, uniform),
                "raw_action": pre_tanh,
                "logits": dist_params,
            }
            return dist.postprocess(pre_tanh), extras

        return mode_policy if deterministic else sampling_policy

    return make_policy
