"""Intention-PPO trainer, on one device or data-parallel over the ranks of a
torch.distributed process group, one GPU each (PyTorch counterpart of
vnl_tpu/training/train.py).

One training step: ``rollouts_per_step`` unrolls of ``unroll_length``
control steps over all envs, flattened to rows; the normaliser update;
``num_updates_per_batch`` shuffled passes over the rows, one Adam update
per minibatch.  The rollout of a step acts with the normaliser from before
that step's update, the SGD with the updated one.  Everything runs in
fp32: the physics pins TF32 off and the flag is global, so the networks'
products are fp32 too.

CUDA graphs (``cuda_graphs``; the default on a CUDA device, never on the
CPU): the control step (policy, env step with its substeps, transition)
is one graph replay (acting.ActorStepGraph), and so is each SGD update
(gradients.gradient_update_fn), the counterparts of the JAX package's
jitted scans (vnl_tpu/training/train.py:202-284); the evaluator replays
its own graph of the eval env's control step (acting.Evaluator).  A control step leaves
the replay and one copy of its transition into the unroll's slot; an
update leaves the copy of its minibatch into the graph's static one, the
replay and one copy of its loss and stats.  The shuffle and the
minibatch gathers of a pass stay outside the graphs.  The graphed run
computes what the eager one computes (``cuda_graphs=False``), draw for
draw from the same generators.

Spans (utils/profiler.py): a training step is a ``train.step`` span, its
id counted from 0 at this call's first step, holding ``train.rollout``,
``train.normalizer``, ``train.sgd`` and ``train.stats``; the logged
``training/sps``, ``training/rollout_s_per_step`` and
``training/sgd_s_per_step`` are read off them.  Inside a
``profiler.recording`` the spans are kept, and the device spans also time
the device.

Checkpoints (``checkpoint_dir``, ``restore_checkpoint_path``) hold the
full TrainingState (training/checkpoint.py).  A checkpoint is written after
every interval, holding the state at the env steps it is named by; the
JAX package's checkpoints trail live progress by one interval, a TPU
transfer workaround left behind here.  ``num_timesteps`` is absolute: a
restored run starts at the restored env steps and Adam step count.  With
``adaptive_clip_weights`` and a multi-clip env, each evaluation sets new
clip weights from the per-clip eval rewards and re-resets every env.

Data parallelism (``num_devices``, the size of an initialised process
group; parallel.initialize): each rank steps ``num_envs // world`` envs
with its own generators (the seed offset by the rank) and a replica of the
networks, initialised from the global seed; the gradients are averaged
and the normaliser's sums added over the ranks by all-reduces, so the
replicas stay equal bit for bit (checked at the end,
``parallel.assert_is_replicated``).  The interval's metrics are averaged
over the ranks; evaluation, progress, the params callback and checkpoints
run on rank 0 only.  Without a process group nothing is all-reduced.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vnl_tpu_torch import models as models_lib
from vnl_tpu_torch.envs.wrappers import wrap_for_training
from vnl_tpu_torch.parallel import mesh as mesh_lib
from vnl_tpu_torch.training import (acting, checkpoint, gradients,
                                    running_statistics)
from vnl_tpu_torch.training import losses as ppo_losses
from vnl_tpu_torch.training.types import Transition
from vnl_tpu_torch.utils import graphs, profiler


@dataclasses.dataclass(frozen=True, eq=False)
class TrainingState:
    """Everything the learner carries across steps: plain tensors and
    state_dicts, so a checkpoint can save it as it is.  ``params`` and
    ``optimizer_state`` refer to the live tensors of the networks and the
    optimizer, which are updated in place.  ``optimizer_state`` is Adam's
    by parameter name (``gradients.adam_state``)."""

    optimizer_state: Dict
    params: Dict[str, Dict[str, torch.Tensor]]     # "policy", "value"
    normalizer_params: running_statistics.RunningStatisticsState
    env_steps: int


# the generators of rank r draw from seed + _RANK_STRIDE * r + (1, 2)
_RANK_STRIDE = 1_000_003


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


EXTRA_FIELDS = ("truncation", "traj")   # the state extras the loss reads


def collect_rollouts(env, env_state, policy, generator, unroll_length: int,
                     rollouts_per_step: int,
                     step: Optional[acting.ActorStepGraph] = None):
    """Fills one training batch: ``rollouts_per_step`` unrolls, each
    (T, B_env, ...), as rows (rollouts * B_env, T, ...).  ``step``: the
    control-step graph (of ``EXTRA_FIELDS``), see generate_unroll."""
    chunks = []
    for _ in range(rollouts_per_step):
        env_state, chunk = acting.generate_unroll(
            env, env_state, policy, generator, unroll_length,
            extra_fields=EXTRA_FIELDS, step=step)
        chunks.append(chunk)
    with profiler.span("rollout.concat", device=True):
        batch = acting.tree_map(
            lambda *xs: torch.cat([x.transpose(0, 1) for x in xs]), *chunks)
    return env_state, batch


def load_training_state(ppo_network, optimizer: gradients.Adam,
                        state: TrainingState) -> None:
    """Copies a TrainingState's parameters into the networks and its Adam
    state into the optimizer (the normaliser is the caller's)."""
    named = dict(ppo_network.named_parameters())
    with torch.no_grad():
        for net in ("policy", "value"):
            for k, v in state.params[net].items():
                if not k.startswith("obs_"):
                    named[f"{net}.{k}"].copy_(v)
    gradients.load_adam_state(optimizer, named, state.optimizer_state)


def clip_weights_from_metrics(metrics: Dict, num_clips: int) -> np.ndarray:
    """New (num_clips,) clip sampling weights from the per-clip eval
    rewards (vnl_tpu/training/train.py:308-320): a clip at the best reward
    keeps the floor weight 0.25, a clip at 0 (or never evaluated) gets
    1.25; normalised to sum to 1."""
    rew = np.array([float(metrics.get(f"eval/episode_reward_clip{c}", 0.0))
                    for c in range(num_clips)])
    deficit = 1.0 - rew / (rew.max() + 1e-8)
    w = np.maximum(deficit, 0.0) + 0.25
    return w / w.sum()


# the training step at whose start train() takes every object built so far
# (the networks, the captured graphs, the state) out of the collector's
# generations (gc.freeze) until it returns: the first steps capture the
# graphs, and a full collection over them takes about 0.1 s, which stalls
# the device wherever it falls
FREEZE_AT_STEP = 2


def sgd_pass(update_step: Callable, batch: Transition, num_minibatches: int,
             generator: Optional[torch.Generator] = None,
             order: Optional[torch.Tensor] = None) -> List[Dict]:
    """One pass over the batch: shuffle the rows (by ``order``, else by a
    permutation drawn from ``generator``), split them into
    ``num_minibatches`` and apply ``update_step(minibatch) -> (loss,
    stats)`` to each in turn.  Returns the stats of every update.  The
    shuffle and the gathers run once a pass, outside a graphed update."""
    n_rows = batch.observation.shape[0]
    with profiler.span("sgd.shuffle", device=True):
        if order is None:
            order = torch.randperm(n_rows, generator=generator,
                                   device=batch.observation.device)
        shuffled = acting.tree_map(
            lambda x: x[order].reshape((num_minibatches, -1) + x.shape[1:]),
            batch)
    stats = []
    for i in range(num_minibatches):
        with profiler.span("sgd.update", device=True):
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
    num_devices: Optional[int] = None,
    restore_checkpoint_path: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    adaptive_clip_weights: bool = False,
    device="cuda",
    cuda_graphs: Optional[bool] = None,
):
    """Runs PPO; returns (make_policy, (normalizer_params, policy
    state_dict), metrics).  ``make_policy(deterministic)`` acts with the
    trained networks.  ``environment`` lives on ``device``, this rank's
    GPU.  ``num_envs`` counts the envs of all ranks; ``num_devices``, when
    given, must be the process group's size (1 without a group).
    ``cuda_graphs``: replay the control step, the SGD update and the
    evaluation's control steps as CUDA graphs (None: on a CUDA device);
    True on the CPU raises."""
    if batch_size * num_minibatches % num_envs != 0:
        raise ValueError(
            "num_envs must divide batch_size * num_minibatches")
    cuda_graphs = graphs.enabled(cuda_graphs, device, "train")
    start_walltime = time.time()

    world, rank = mesh_lib.world_size(), mesh_lib.rank()
    data_parallel = mesh_lib.process_group() is not None
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices}, but there are {world} "
                         "processes (one a device; parallel.initialize)")
    logging.info("processes: %d (rank %d)", world, rank)
    if num_envs % world != 0:
        raise ValueError(f"num_envs={num_envs} not divisible by {world}")
    num_envs_local = num_envs // world

    steps_per_training_step = (
        batch_size * unroll_length * num_minibatches * action_repeat)
    intervals = max(num_evals - 1, 1)
    steps_per_interval = int(np.ceil(
        num_timesteps / (intervals * steps_per_training_step)))
    rollouts_per_step = batch_size * num_minibatches // num_envs

    # the networks' initial values come from a CPU generator seeded alike
    # on every rank, so they do not depend on the device or the rank;
    # rollouts, shuffles and the loss's noise draw from one device
    # generator, the evaluator from another, each offset by the rank
    init_gen = torch.Generator().manual_seed(seed)
    rank_seed = seed + _RANK_STRIDE * rank
    gen = torch.Generator(device=device).manual_seed(rank_seed + 1)
    eval_gen = torch.Generator(device=device).manual_seed(rank_seed + 2)

    env = wrap_for_training(environment, episode_length=episode_length,
                            action_repeat=action_repeat)
    env_state = env.reset(num_envs_local, generator=gen)

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
    update_step = gradients.gradient_update_fn(
        loss_fn, optimizer, has_aux=True, data_parallel=data_parallel,
        cuda_graph=cuda_graphs, generators=(gen,))
    # the env state lives in the graph's static state from its first
    # replay on; a rebound env_state (the re-reset of adaptive clip
    # weights) is copied into it by the next unroll
    actor = (acting.ActorStepGraph(env, policy, gen, EXTRA_FIELDS)
             if cuda_graphs else None)

    named_parameters = dict(ppo_network.named_parameters())

    def snapshot(normalizer_params, env_steps) -> TrainingState:
        return TrainingState(
            optimizer_state=gradients.adam_state(optimizer,
                                                 named_parameters),
            params={"policy": ppo_network.policy.state_dict(),
                    "value": ppo_network.value.state_dict()},
            normalizer_params=normalizer_params, env_steps=env_steps)

    training_state = snapshot(
        running_statistics.init_state(env_state.obs.shape[-1:],
                                      device=device), 0)
    if restore_checkpoint_path is not None:
        restored = checkpoint.restore(restore_checkpoint_path, device=device)
        load_training_state(ppo_network, optimizer, restored)
        if normalize_observations:
            ppo_network.set_normalizer(restored.normalizer_params)
        training_state = snapshot(restored.normalizer_params,
                                  restored.env_steps)

    step_ids = itertools.count()      # training steps, from 0

    def one_training_step(ts: TrainingState, env_state):
        _sync(device)
        step_id = next(step_ids)
        if step_id == FREEZE_AT_STEP:
            gc.collect()
            gc.freeze()
        with profiler.timed("train.step", step=step_id) as step:
            with profiler.timed("train.rollout") as rollout:
                env_state, batch = collect_rollouts(
                    env, env_state, policy, gen, unroll_length,
                    rollouts_per_step, step=actor)
                _sync(device)
            with profiler.span("train.normalizer", device=True):
                normalizer_params = running_statistics.update(
                    ts.normalizer_params, batch.observation,
                    data_parallel=data_parallel)
                if normalize_observations:
                    ppo_network.set_normalizer(normalizer_params)
            with profiler.timed("train.sgd"):
                stats = []
                for _ in range(num_updates_per_batch):
                    stats += sgd_pass(update_step, batch, num_minibatches,
                                      gen)
                with profiler.span("sgd.flush", device=True):
                    optimizer.flush()
            # every update's stats as one row, so that the interval reads
            # them back in a single transfer
            with profiler.span("train.stats", device=True):
                rows = torch.stack([torch.stack([s[n] for n in sorted(s)])
                                    for s in stats])
            _sync(device)
        ts = dataclasses.replace(
            ts, normalizer_params=normalizer_params,
            env_steps=ts.env_steps + steps_per_training_step)
        # seconds of the step, of its rollout, and of the rest: the
        # normaliser, the SGD and the stats
        return ts, env_state, rows, (step.seconds, rollout.seconds,
                                     step.seconds - rollout.seconds)

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
        stats = torch.cat(rows).mean(0)
        if data_parallel:
            (stats,) = mesh_lib.all_reduce_mean([stats],
                                                name="metrics_all_reduce")
        stats_host = stats.cpu().numpy()
        elapsed = time.time() - t0
        training_walltime += elapsed
        step_s, rollout_s, sgd_s = np.mean(times, axis=0)
        metrics = {
            "training/sps": steps_per_training_step / step_s,
            "training/walltime": training_walltime,
            "training/rollout_s_per_step": float(rollout_s),
            "training/sgd_s_per_step": float(sgd_s),
            **{f"training/{name}": float(stats_host[i])
               for i, name in enumerate(stat_names)},
        }
        return ts, env_state, metrics

    clip_lib = getattr(environment, "clip_library", None)
    adaptive_clip_weights = adaptive_clip_weights and clip_lib is not None
    if adaptive_clip_weights and world > 1:
        raise NotImplementedError(
            "adaptive_clip_weights needs a cross-process weight broadcast; "
            "run one process or disable it")

    evaluator = acting.Evaluator(
        wrap_for_training(eval_env or environment,
                          episode_length=episode_length,
                          action_repeat=action_repeat),
        make_policy(deterministic=deterministic_eval),
        num_eval_envs=num_eval_envs, episode_length=episode_length,
        action_repeat=action_repeat, generator=eval_gen,
        cuda_graphs=cuda_graphs)

    def params_of(ts):
        return ts.normalizer_params, ts.params["policy"]

    metrics = {}
    if rank == 0 and num_evals > 1:
        metrics = evaluator.run_evaluation(training_metrics={})
        logging.info(metrics)
        progress_fn(0, metrics)

    current_step, interval = training_state.env_steps, -1
    try:
        while current_step < num_timesteps:
            interval += 1
            logging.info("starting interval %s t=%.1fs", interval,
                         time.time() - start_walltime)
            training_state, env_state, training_metrics = run_interval(
                training_state, env_state)
            training_state = snapshot(training_state.normalizer_params,
                                      training_state.env_steps)
            current_step = training_state.env_steps
            if rank != 0:
                continue
            metrics = evaluator.run_evaluation(training_metrics)
            if adaptive_clip_weights:
                w = clip_weights_from_metrics(metrics, clip_lib.num_clips)
                env_state = env.reset(
                    num_envs_local, generator=gen,
                    clip_weights=torch.as_tensor(w, dtype=torch.float32,
                                                 device=device))
                metrics.update({f"training/clip_weight_{c}": float(w[c])
                                for c in range(len(w))})
            logging.info(metrics)
            progress_fn(current_step, metrics)
            policy_params_fn(current_step, make_policy,
                             params_of(training_state))
            if checkpoint_dir is not None:
                checkpoint.save_async(checkpoint_dir, current_step,
                                      training_state)
    finally:
        gc.unfreeze()
    checkpoint.wait_for_pending_saves()
    mesh_lib.assert_is_replicated(training_state)
    logging.info("total steps: %s", current_step)
    mesh_lib.synchronize_hosts()
    return make_policy, params_of(training_state), metrics
