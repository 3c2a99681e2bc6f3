"""Intention-PPO trainer on one device (PyTorch counterpart of
vnl_tpu/training/train.py).

One training step: ``rollouts_per_step`` unrolls of ``unroll_length``
control steps over all envs, flattened to rows; the normaliser update;
``num_updates_per_batch`` shuffled passes over the rows, one Adam update
per minibatch.  The rollout of a step acts with the normaliser from before
that step's update, the SGD with the updated one.  Everything runs eagerly
(no graph capture) and in fp32: the physics pins TF32 off and the flag is
global, so the networks' products are fp32 too.

Not here yet: the device mesh and the gradient all-reduce
(``num_devices``), checkpoints (``restore_checkpoint_path``,
``checkpoint_dir``) and adaptive clip weights of the multi-clip env.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vnl_tpu_torch import models as models_lib
from vnl_tpu_torch.envs.wrappers import wrap_for_training
from vnl_tpu_torch.training import acting, gradients, running_statistics
from vnl_tpu_torch.training import losses as ppo_losses
from vnl_tpu_torch.training.types import Transition


@dataclasses.dataclass(frozen=True, eq=False)
class TrainingState:
    """Everything the learner carries across steps: plain tensors and
    state_dicts, so a checkpoint can save it as it is.  ``params`` and
    ``optimizer_state`` refer to the live tensors of the networks and the
    optimizer, which are updated in place."""

    optimizer_state: Dict
    params: Dict[str, Dict[str, torch.Tensor]]     # "policy", "value"
    normalizer_params: running_statistics.RunningStatisticsState
    env_steps: int


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def collect_rollouts(env, env_state, policy, generator, unroll_length: int,
                     rollouts_per_step: int):
    """Fills one training batch: ``rollouts_per_step`` unrolls, each
    (T, B_env, ...), as rows (rollouts * B_env, T, ...)."""
    chunks = []
    for _ in range(rollouts_per_step):
        env_state, chunk = acting.generate_unroll(
            env, env_state, policy, generator, unroll_length,
            extra_fields=("truncation", "traj"))
        chunks.append(chunk)
    batch = acting.tree_map(
        lambda *xs: torch.cat([x.transpose(0, 1) for x in xs]), *chunks)
    return env_state, batch


def sgd_pass(update_step: Callable, batch: Transition, num_minibatches: int,
             generator: Optional[torch.Generator] = None,
             order: Optional[torch.Tensor] = None) -> List[Dict]:
    """One pass over the batch: shuffle the rows (by ``order``, else by a
    permutation drawn from ``generator``), split them into
    ``num_minibatches`` and apply ``update_step(minibatch) -> (loss,
    stats)`` to each in turn.  Returns the stats of every update."""
    n_rows = batch.observation.shape[0]
    if order is None:
        order = torch.randperm(n_rows, generator=generator,
                               device=batch.observation.device)
    shuffled = acting.tree_map(
        lambda x: x[order].reshape((num_minibatches, -1) + x.shape[1:]),
        batch)
    stats = []
    for i in range(num_minibatches):
        _, s = update_step(acting.tree_map(lambda x: x[i], shuffled))
        stats.append(s)
    return stats


def train(
    environment,
    num_timesteps: int,
    episode_length: int,
    action_repeat: int = 1,
    num_envs: int = 1,
    num_eval_envs: int = 128,
    learning_rate: float = 1e-4,
    entropy_cost: float = 1e-4,
    discounting: float = 0.9,
    seed: int = 0,
    unroll_length: int = 10,
    batch_size: int = 32,
    num_minibatches: int = 16,
    num_updates_per_batch: int = 2,
    num_evals: int = 1,
    normalize_observations: bool = False,
    reward_scaling: float = 1.0,
    clipping_epsilon: float = 0.3,
    gae_lambda: float = 0.95,
    deterministic_eval: bool = False,
    network_factory=models_lib.make_intention_ppo_networks,
    progress_fn: Callable = lambda *args: None,
    normalize_advantage: bool = True,
    eval_env=None,
    policy_params_fn: Callable = lambda *args: None,
    kl_weight: float = 1e-4,
    device="cuda",
):
    """Runs PPO; returns (make_policy, (normalizer_params, policy
    state_dict), metrics).  ``make_policy(deterministic)`` acts with the
    trained networks.  ``environment`` lives on ``device``."""
    if batch_size * num_minibatches % num_envs != 0:
        raise ValueError(
            "num_envs must divide batch_size * num_minibatches")
    start_walltime = time.time()

    steps_per_training_step = (
        batch_size * unroll_length * num_minibatches * action_repeat)
    intervals = max(num_evals - 1, 1)
    steps_per_interval = int(np.ceil(
        num_timesteps / (intervals * steps_per_training_step)))
    rollouts_per_step = batch_size * num_minibatches // num_envs

    # the networks' initial values come from a CPU generator, so they do
    # not depend on the device; rollouts, shuffles and the loss's noise
    # draw from one device generator, the evaluator from another
    init_gen = torch.Generator().manual_seed(seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    eval_gen = torch.Generator(device=device).manual_seed(seed + 2)

    env = wrap_for_training(environment, episode_length=episode_length,
                            action_repeat=action_repeat)
    env_state = env.reset(num_envs, generator=gen)

    ppo_network = network_factory(
        env_state.info["traj"].shape[-1], env_state.obs.shape[-1],
        env.action_size, generator=init_gen, device=device)
    make_policy = models_lib.make_inference_fn(ppo_network)
    policy = make_policy(deterministic=False)

    optimizer = gradients.make_adam(ppo_network.parameters(), learning_rate)
    loss_fn = functools.partial(
        ppo_losses.compute_ppo_intention_loss, ppo_network, generator=gen,
        entropy_cost=entropy_cost, discounting=discounting,
        reward_scaling=reward_scaling, gae_lambda=gae_lambda,
        clipping_epsilon=clipping_epsilon,
        normalize_advantage=normalize_advantage, kl_weight=kl_weight)
    update_step = gradients.gradient_update_fn(loss_fn, optimizer,
                                               has_aux=True)

    def snapshot(normalizer_params, env_steps) -> TrainingState:
        return TrainingState(
            optimizer_state=optimizer.state_dict(),
            params={"policy": ppo_network.policy.state_dict(),
                    "value": ppo_network.value.state_dict()},
            normalizer_params=normalizer_params, env_steps=env_steps)

    training_state = snapshot(
        running_statistics.init_state(env_state.obs.shape[-1:],
                                      device=device), 0)

    def one_training_step(ts: TrainingState, env_state):
        _sync(device)
        t0 = time.perf_counter()
        env_state, batch = collect_rollouts(
            env, env_state, policy, gen, unroll_length, rollouts_per_step)
        _sync(device)
        t1 = time.perf_counter()
        normalizer_params = running_statistics.update(
            ts.normalizer_params, batch.observation)
        if normalize_observations:
            ppo_network.set_normalizer(normalizer_params)
        stats = []
        for _ in range(num_updates_per_batch):
            stats += sgd_pass(update_step, batch, num_minibatches, gen)
        # every update's stats as one row, so that the interval reads
        # them back in a single transfer
        rows = torch.stack([torch.stack([s[n] for n in sorted(s)])
                            for s in stats])
        _sync(device)
        t2 = time.perf_counter()
        ts = dataclasses.replace(
            ts, normalizer_params=normalizer_params,
            env_steps=ts.env_steps + steps_per_training_step)
        return ts, env_state, rows, (t1 - t0, t2 - t1)

    stat_names = sorted(("total_loss", "policy_loss", "v_loss",
                         "entropy_loss", "kl_loss_intention",
                         "prediction_corr", "explained_variance"))
    training_walltime = 0.0

    def run_interval(ts, env_state):
        nonlocal training_walltime
        t0 = time.time()
        rows, times = [], []
        for _ in range(steps_per_interval):
            ts, env_state, r, t = one_training_step(ts, env_state)
            rows.append(r)
            times.append(t)
        stats_host = torch.cat(rows).mean(0).cpu().numpy()
        elapsed = time.time() - t0
        training_walltime += elapsed
        rollout_s, sgd_s = np.mean(times, axis=0)
        metrics = {
            "training/sps":
                steps_per_interval * steps_per_training_step / elapsed,
            "training/walltime": training_walltime,
            "training/rollout_s_per_step": float(rollout_s),
            "training/sgd_s_per_step": float(sgd_s),
            **{f"training/{name}": float(stats_host[i])
               for i, name in enumerate(stat_names)},
        }
        return ts, env_state, metrics

    evaluator = acting.Evaluator(
        wrap_for_training(eval_env or environment,
                          episode_length=episode_length,
                          action_repeat=action_repeat),
        make_policy(deterministic=deterministic_eval),
        num_eval_envs=num_eval_envs, episode_length=episode_length,
        action_repeat=action_repeat, generator=eval_gen)

    def params_of(ts):
        return ts.normalizer_params, ts.params["policy"]

    metrics = {}
    if num_evals > 1:
        metrics = evaluator.run_evaluation(training_metrics={})
        logging.info(metrics)
        progress_fn(0, metrics)

    current_step, interval = 0, -1
    while current_step < num_timesteps:
        interval += 1
        logging.info("starting interval %s t=%.1fs", interval,
                     time.time() - start_walltime)
        training_state, env_state, training_metrics = run_interval(
            training_state, env_state)
        training_state = snapshot(training_state.normalizer_params,
                                  training_state.env_steps)
        current_step = training_state.env_steps
        metrics = evaluator.run_evaluation(training_metrics)
        logging.info(metrics)
        progress_fn(current_step, metrics)
        policy_params_fn(current_step, make_policy,
                         params_of(training_state))

    logging.info("total steps: %s", current_step)
    return make_policy, params_of(training_state), metrics
