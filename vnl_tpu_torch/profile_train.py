"""Where the time of one training step of the port goes, on one CUDA
device.

Sets up what ``train(...)`` sets up at the widths of vnl_tpu_torch/bench.py
(1024 envs on the rodent twin, networks (1024, 1024), unroll 20, 32
minibatches, 16 passes), warms up, and then takes one training step apart:
the rollout (one 20-step unroll), the normaliser update, the SGD (16 x 32
minibatch updates) and an evaluation (128 envs, 150 steps).  Each part is
timed on the host clock between synchronisations; the rollout and one SGD
pass are also traced with torch.profiler for the device time by kernel
group and the device's busy share (kernel time over the unprofiled wall
time of the same work; the profiler inflates the wall time).  Prints one
JSON line.

  python3 -m vnl_tpu_torch.profile_train [--fused-position 0|1]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import torch

from vnl_tpu_torch.bench import TRAIN_KW, gpu_name_and_power_limit
from vnl_tpu_torch.profile_rollout import device_groups


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def traced(fn):
    """(result, profiled wall s, {group: device ms}, {group: launches})."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, wall = timed(fn)
    groups, launches = device_groups(prof)
    return (out, wall, {k: v / 1e3 for k, v in groups.most_common()},
            dict(launches.most_common()))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fused-position", type=int, choices=(0, 1), default=1)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    from vnl_tpu_torch import models
    from vnl_tpu_torch.envs import make_twin_env, wrap_for_training
    from vnl_tpu_torch.ops import build
    from vnl_tpu_torch.physics.forward import pin_fp32
    from vnl_tpu_torch.training import (Evaluator, compute_ppo_intention_loss,
                                        running_statistics)
    from vnl_tpu_torch.training import gradients
    from vnl_tpu_torch.training.train import collect_rollouts, sgd_pass

    build.build_all()
    pin_fp32()
    kw = TRAIN_KW
    dev = "cuda"
    raw_env = make_twin_env(device=dev,
                            fused_position=bool(args.fused_position))
    env = wrap_for_training(raw_env, episode_length=kw["episode_length"])
    gen = torch.Generator(device=dev).manual_seed(1)
    env_state = env.reset(kw["num_envs"], generator=gen)
    net = models.make_intention_ppo_networks(
        env_state.info["traj"].shape[-1], env_state.obs.shape[-1],
        env.action_size, generator=torch.Generator().manual_seed(0),
        device=dev)
    make_policy = models.make_inference_fn(net)
    policy = make_policy(deterministic=False)
    optimizer = gradients.make_adam(net.parameters(), kw["learning_rate"])
    update_step = gradients.gradient_update_fn(functools.partial(
        compute_ppo_intention_loss, net, generator=gen,
        entropy_cost=kw["entropy_cost"], discounting=kw["discounting"],
        reward_scaling=kw["reward_scaling"], gae_lambda=kw["gae_lambda"],
        clipping_epsilon=kw["clipping_epsilon"], kl_weight=kw["kl_weight"]),
        optimizer, has_aux=True)
    norm = running_statistics.init_state(env_state.obs.shape[-1:],
                                         device=dev)
    nmb, passes = kw["num_minibatches"], kw["num_updates_per_batch"]
    unroll = kw["unroll_length"]

    def rollout(state):
        return collect_rollouts(env, state, policy, gen, unroll, 1)

    def one_pass(batch):
        return sgd_pass(update_step, batch, nmb, gen)

    # warm-up: one unroll and one pass
    env_state, batch = rollout(env_state)
    one_pass(batch)

    (env_state, batch), rollout_s = timed(lambda: rollout(env_state))
    norm, norm_s = timed(lambda: running_statistics.update(
        norm, batch.observation))
    net.set_normalizer(norm)
    _, sgd_s = timed(lambda: [one_pass(batch) for _ in range(passes)])
    evaluator = Evaluator(
        wrap_for_training(raw_env, episode_length=kw["episode_length"]),
        make_policy(deterministic=False), num_eval_envs=128,
        episode_length=kw["episode_length"], action_repeat=1,
        generator=torch.Generator(device=dev).manual_seed(2))
    _, eval_s = timed(lambda: evaluator.run_evaluation({}))

    (env_state, batch), r_wall, r_dev, r_launch = traced(
        lambda: rollout(env_state))
    _, p_wall, p_dev, p_launch = traced(lambda: one_pass(batch))

    step_s = rollout_s + norm_s + sgd_s
    rollout_busy = sum(r_dev.values()) / 1e3
    sgd_busy = sum(p_dev.values()) / 1e3 * passes
    out = dict(
        device=torch.cuda.get_device_name(0),
        name_and_power_limit=gpu_name_and_power_limit(),
        fused_position=bool(args.fused_position), num_envs=kw["num_envs"],
        training_step_s=step_s,
        training_env_steps_per_s=kw["num_envs"] * unroll / step_s,
        wall_s=dict(rollout=rollout_s, normaliser=norm_s, sgd=sgd_s,
                    evaluation_128x150=eval_s),
        share_of_step=dict(rollout=rollout_s / step_s,
                           normaliser=norm_s / step_s, sgd=sgd_s / step_s),
        rollout_device_ms=r_dev, rollout_launches=r_launch,
        rollout_profiled_wall_s=r_wall,
        rollout_device_busy_share=rollout_busy / rollout_s,
        sgd_pass_device_ms=p_dev, sgd_pass_launches=p_launch,
        sgd_pass_profiled_wall_s=p_wall,
        sgd_device_busy_share=sgd_busy / sgd_s,
        step_device_busy_share=(rollout_busy + sgd_busy) / step_s)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
