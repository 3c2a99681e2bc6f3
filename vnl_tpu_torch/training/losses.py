"""PPO surrogate + value + entropy + intention-KL loss (PyTorch counterpart
of vnl_tpu/training/losses.py).

TD(lambda) targets and advantages come from one reverse pass over the
unroll (``compute_gae``: kernel F on a CUDA device, ops/gae.py); the
surrogate is the clipped importance ratio; the value loss is
weighted 0.25; the entropy bonus uses one fresh sample; the VAE regulariser
KL(posterior || N(0, 1)) is scaled by kl_weight.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vnl_tpu_torch.ops.gae import compute_gae
from vnl_tpu_torch.training.types import Metrics, Transition
from vnl_tpu_torch.utils import profiler


def correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of two vectors, in [-1, 1]: torch.corrcoef's
    off-diagonal entry without its check of the degrees of freedom, which
    reads a device value on the host and so cannot be captured in a CUDA
    graph."""
    da, db = a - a.mean(), b - b.mean()
    return torch.clamp((da * db).sum() / torch.sqrt((da * da).sum()
                                                    * (db * db).sum()),
                       -1.0, 1.0)


def kl_divergence(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Mean elementwise KL(N(mean, exp(logvar)) || N(0, 1))."""
    return 0.5 * torch.mean(mean ** 2 + torch.exp(logvar) - logvar - 1.0)


def compute_ppo_intention_loss(
    ppo_network,
    data: Transition,
    generator: Optional[torch.Generator] = None,
    latent_noise: Optional[torch.Tensor] = None,
    entropy_noise: Optional[torch.Tensor] = None,
    entropy_cost: float = 1e-4,
    discounting: float = 0.9,
    reward_scaling: float = 1.0,
    gae_lambda: float = 0.95,
    clipping_epsilon: float = 0.3,
    normalize_advantage: bool = True,
    kl_weight: float = 1e-4,
) -> Tuple[torch.Tensor, Metrics]:
    """Total loss and metrics of one minibatch.

    ``data`` carries [B, T] leading dims and needs
    extras.state_extras.{truncation, traj} and
    extras.policy_extras.{raw_action, log_prob}.  The networks read their
    own normaliser (PPOImitationNetworks.set_normalizer).  ``latent_noise``
    (T, B, latent) and ``entropy_noise`` (T, B, action) are standard-normal
    draws, taken from ``generator`` when not given."""
    dist = ppo_network.parametric_action_distribution

    def tm(x):                       # time-major view
        return x.transpose(0, 1)

    obs = tm(data.observation)
    traj = tm(data.extras["state_extras"]["traj"])
    truncation = tm(data.extras["state_extras"]["truncation"])
    behaviour_raw = tm(data.extras["policy_extras"]["raw_action"])
    behaviour_logp = tm(data.extras["policy_extras"]["log_prob"])
    rewards = tm(data.reward) * reward_scaling
    # discount == 0 and not truncated <=> the environment terminated
    termination = (1.0 - tm(data.discount)) * (1.0 - truncation)

    dist_params, post_mean, post_logvar = ppo_network.policy(
        traj, obs, latent_noise, generator)
    values = ppo_network.value_apply(obs)
    tail_value = ppo_network.value_apply(tm(data.next_observation)[-1])

    with profiler.part("gae"):
        targets, advantages = compute_gae(
            truncation=truncation, termination=termination, rewards=rewards,
            values=values.detach(), bootstrap_value=tail_value.detach(),
            lambda_=gae_lambda, discount=discounting)
    if normalize_advantage:
        advantages = ((advantages - advantages.mean())
                      / (advantages.std(unbiased=False) + 1e-8))

    log_ratio = dist.log_prob(dist_params, behaviour_raw) - behaviour_logp
    ratio = torch.exp(log_ratio)
    clipped_ratio = torch.clamp(ratio, 1.0 - clipping_epsilon,
                                1.0 + clipping_epsilon)
    surrogate = -torch.mean(torch.minimum(ratio * advantages,
                                          clipped_ratio * advantages))

    value_loss = 0.25 * torch.mean((targets - values) ** 2)
    entropy_bonus = -entropy_cost * torch.mean(
        dist.entropy(dist_params, entropy_noise, generator))
    posterior_kl = kl_weight * kl_divergence(post_mean, post_logvar)

    total = surrogate + value_loss + entropy_bonus + posterior_kl
    with torch.no_grad():
        corr = correlation(targets.reshape(-1), rewards.reshape(-1))
        metrics = {
            "total_loss": total.detach(),
            "policy_loss": surrogate.detach(),
            "v_loss": value_loss.detach(),
            "entropy_loss": entropy_bonus.detach(),
            "kl_loss_intention": posterior_kl.detach(),
            "prediction_corr": corr,
            "explained_variance":
                1.0 - value_loss.detach() / rewards.var(unbiased=False),
        }
    return total, metrics
