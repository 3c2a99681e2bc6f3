"""Training env-steps/s of the port on one CUDA device: the counterpart of
the JAX package's bench.py train mode, on the rodent twin.

Runs ``train(...)`` at the reference hyperparameters (1024 envs, batch 32,
unroll 20, 32 minibatches, 16 updates per batch, episode length 150, lr
6e-4, entropy 1e-3, discount 0.99, clip 0.2, lambda 0.95, KL 1e-4,
normalised observations, networks (1024, 1024), 128 eval envs) for two
intervals of ``--steps`` training steps, each followed by an evaluation.
The first interval warms up; the second is reported in one JSON line:
training env-steps/s, the seconds per training step split into rollout and
SGD, the launches of kernels A, B and C over the whole run, the card's
name and its power limit.

  python3 -m vnl_tpu_torch.bench [--fused-position 0|1] [--steps N]

Data-parallel over N GPUs of one host, one process each, 1024 envs and a
batch of 32 per GPU (rank 0 prints the line, with the process count;
env-steps/s counts the envs of all ranks):

  python3 -m torch.distributed.run --nproc_per_node=N -m vnl_tpu_torch.bench

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

NUM_ENVS = 1024
TRAIN_KW = dict(
    episode_length=150, num_envs=NUM_ENVS, num_eval_envs=128,
    learning_rate=6e-4,
    entropy_cost=1e-3, discounting=0.99, unroll_length=20,
    batch_size=NUM_ENVS // 32, num_minibatches=32, num_updates_per_batch=16,
    normalize_observations=True, reward_scaling=1.0, clipping_epsilon=0.2,
    gae_lambda=0.95, kl_weight=1e-4, seed=0)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(fused_position: bool, steps: int, **overrides) -> dict:
    """Trains for a warm-up interval and a measured interval of ``steps``
    training steps each (``overrides`` replace arguments of ``train``);
    returns the measured interval's numbers and the kernel launches counted
    since the caller last reset them."""
    from vnl_tpu_torch.envs import make_twin_env
    from vnl_tpu_torch.ops import launch_counts
    from vnl_tpu_torch.training import train

    env = make_twin_env(device="cuda", fused_position=fused_position)
    kw = dict(TRAIN_KW, **overrides)
    per_step = (kw["batch_size"] * kw["unroll_length"]
                * kw["num_minibatches"])
    seen = []
    # three evaluations = two intervals: the first warms up
    train(env, num_timesteps=2 * steps * per_step, num_evals=3,
          progress_fn=lambda step, m: seen.append((step, m)),
          device="cuda", **kw)
    if not seen:               # a rank other than 0: rank 0 reports
        return {}
    step, last = seen[-1]
    return {
        "fused_position": fused_position,
        "training_steps": steps,
        "env_steps": step,
        "training_env_steps_per_s": last["training/sps"],
        "rollout_s_per_training_step": last["training/rollout_s_per_step"],
        "sgd_s_per_training_step": last["training/sgd_s_per_step"],
        "eval_s": last["eval/epoch_eval_time"],
        "metrics": {k: float(v) for k, v in last.items()},
        "launches": {k: launch_counts.get(k, 0)
                     for k in ("position", "cg", "sweep")},
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fused-position", type=int, choices=(0, 1), default=1)
    p.add_argument("--steps", type=int, default=3,
                   help="training steps in the measured interval")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("vnl_tpu_torch.bench: no CUDA device", file=sys.stderr)
        return 1
    from vnl_tpu_torch import parallel
    from vnl_tpu_torch.ops import reset_launch_counts
    from vnl_tpu_torch.parallel import mesh
    if "LOCAL_RANK" in os.environ:               # torch.distributed.run
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    parallel.initialize(device="cuda")
    world = mesh.world_size()
    reset_launch_counts()
    out = run(bool(args.fused_position), args.steps, num_devices=world,
              num_envs=NUM_ENVS * world,
              batch_size=TRAIN_KW["batch_size"] * world)
    if mesh.rank() == 0:
        out["processes"] = world
        out["device"] = torch.cuda.get_device_name(0)
        out["name_and_power_limit"] = gpu_name_and_power_limit()
        print(json.dumps(out), flush=True)
    if world > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
