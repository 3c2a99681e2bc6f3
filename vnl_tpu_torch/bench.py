"""Env-steps/s of the port on one CUDA device, on the rodent twin: the
counterpart of the JAX package's bench.py, in its two modes.

``--mode train`` (the default) runs ``train(...)`` at the reference
hyperparameters (1024 envs, batch 32, unroll 20, 32 minibatches, 16
updates per batch, episode length 150, lr 6e-4, entropy 1e-3, discount
0.99, clip 0.2, lambda 0.95, KL 1e-4, normalised observations, networks
(1024, 1024), 128 eval envs) for two intervals of ``--steps`` training
steps, each followed by an evaluation.  The first interval warms up; the
line reports the second: training env-steps/s, the seconds per training
step split into rollout and SGD and the launches of kernels A, B and C
over the whole run.

``--mode stepping`` steps the twin env raw (``run_stepping``): random
actions 0.3 N(0, 1), no policy, no learner and no auto-reset, five
samples of 20 control steps after two warm-up calls, as the JAX bench's
stepping mode (``jax.vmap(env.step)`` in a scan) does.

Both replay CUDA graphs, as the JAX bench runs compiled programs: the
training mode its control step and SGD update (``train``'s
``cuda_graphs``), the stepping mode ``env.step`` with its action draw
(an ``envs.StateGraph``).  ``--eager`` runs the same work without graphs, one
launch from the host for every kernel.

Both print one JSON line with the JAX bench's keys (``metric``,
``value``: the best sample, ``unit``, ``mode``, ``median``: of the last
half of the samples, ``samples``: their count), ``cuda_graphs``, the
card's name and its power limit, beside the mode's own keys:

  python3 -m vnl_tpu_torch.bench [--mode train|stepping] [--envs N]
                                 [--fused-position 0|1] [--steps N]
                                 [--eager]

Data-parallel over N GPUs of one host, one process each, ``--envs`` envs
(1024 by default) and a batch of envs / 32 per GPU (rank 0 prints the
line, with the process count; env-steps/s counts the envs of all ranks,
stepping over the slowest rank's time):

  python3 -m torch.distributed.run --nproc_per_node=N -m vnl_tpu_torch.bench

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

import torch

from vnl_tpu_torch.ops import launch_counts, reset_launch_counts

NUM_ENVS = 1024
TRAIN_KW = dict(
    episode_length=150, num_envs=NUM_ENVS, num_eval_envs=128,
    learning_rate=6e-4,
    entropy_cost=1e-3, discounting=0.99, unroll_length=20,
    batch_size=NUM_ENVS // 32, num_minibatches=32, num_updates_per_batch=16,
    normalize_observations=True, reward_scaling=1.0, clipping_epsilon=0.2,
    gae_lambda=0.95, kl_weight=1e-4, seed=0)
KERNELS = ("position", "cg", "sweep")


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def summary(mode: str, samples) -> dict:
    """The JAX bench's keys (bench.py:181-214, without ``vs_baseline``):
    the best sample, and the median of the last half of them."""
    tail = samples[len(samples) // 2:] or samples
    return {"metric": "rodent_imitation_env_steps_per_s",
            "value": max(samples), "unit": "env-steps/s", "mode": mode,
            "median": statistics.median(tail), "samples": len(samples)}


def run(fused_position: bool, steps: int, device="cuda", env=None,
        **overrides) -> dict:
    """Trains for a warm-up interval and a measured interval of ``steps``
    training steps each (``overrides`` replace arguments of ``train``;
    ``env`` the twin env, for the CPU tests); returns the measured
    interval's numbers (``eval_s`` its evaluation's seconds, and
    ``first_eval_s`` those of the first, with its graph's capture), the
    training env-steps/s of both intervals as the
    samples, the kernel launches counted since the caller last reset
    them and the reports of the run's graph captures (``cuda_graphs``
    among ``overrides``: train's; by default graphs on a CUDA device)."""
    from vnl_tpu_torch.envs import make_twin_env
    from vnl_tpu_torch.training import train
    from vnl_tpu_torch.utils import graphs

    if env is None:
        env = make_twin_env(device=device, fused_position=fused_position)
    kw = dict(TRAIN_KW, **overrides)
    per_step = (kw["batch_size"] * kw["unroll_length"]
                * kw["num_minibatches"])
    seen = []
    captures = len(graphs.REPORTS)
    if kw.get("cuda_graphs") is None:
        kw["cuda_graphs"] = torch.device(device).type == "cuda"
    # three evaluations = two intervals: the first warms up
    train(env, num_timesteps=2 * steps * per_step, num_evals=3,
          progress_fn=lambda step, m: seen.append((step, m)),
          device=device, **kw)
    if not seen:               # a rank other than 0: rank 0 reports
        return {}
    step, last = seen[-1]
    sps = [m["training/sps"] for _, m in seen if "training/sps" in m]
    return {
        **summary("train", sps),
        "cuda_graphs": kw["cuda_graphs"],
        "fused_position": fused_position,
        "training_steps": steps,
        "env_steps": step,
        "training_env_steps_per_s": last["training/sps"],
        "sample_env_steps_per_s": sps,
        "rollout_s_per_training_step": last["training/rollout_s_per_step"],
        "sgd_s_per_training_step": last["training/sgd_s_per_step"],
        "eval_s": last["eval/epoch_eval_time"],
        "first_eval_s": seen[0][1]["eval/epoch_eval_time"],
        "metrics": {k: float(v) for k, v in last.items()},
        "launches": {k: launch_counts.get(k, 0) for k in KERNELS},
        "graphs": graphs.REPORTS[captures:],
    }


def run_stepping(device="cuda", batch: int = NUM_ENVS, n_steps: int = 20,
                 samples: int = 5, warmup: int = 2,
                 fused_position: bool = True, seed: int = 0, env=None,
                 state=None, actions=None,
                 cuda_graphs: Optional[bool] = None) -> dict:
    """Raw env-steps/s of ``batch`` twin envs (bench.py:138-178): reset
    from a generator seeded with ``seed``, then ``warmup`` calls and
    ``samples`` timed calls of ``n_steps`` ``env.step`` each, with actions
    0.3 N(0, 1) in float32 from the same generator.  No policy, no
    normaliser, no auto-reset: a terminated env steps on.  Each sample is
    timed between two ``torch.cuda.synchronize()`` on a CUDA device; with
    a process group of several ranks, each steps its own ``batch`` envs
    and a sample's time is the slowest rank's.

    ``env``, ``state`` and ``actions`` (n_steps, batch, action_size),
    used by every call, replace the twin env, its reset and the random
    actions (the CPU tests, eager only).  ``cuda_graphs`` (None: on a
    CUDA device) replays each step with its draw as one CUDA graph
    (``envs.StateGraph``); True on the CPU raises.  Returns the summary,
    the env-steps/s of each sample, the launches of kernels A, B and C in
    each sample, the capture's report and the final ``state``."""
    from vnl_tpu_torch.envs import StateGraph, make_twin_env
    from vnl_tpu_torch.parallel import mesh
    cuda = torch.device(device).type == "cuda"
    if cuda_graphs is None:
        cuda_graphs = cuda
    if cuda_graphs and (not cuda or actions is not None):
        raise ValueError("the env-step graph needs a CUDA device and draws "
                         "its own actions; run eagerly (cuda_graphs=False)")
    if env is None:
        env = make_twin_env(device=device, fused_position=fused_position)
    gen = torch.Generator(device=device).manual_seed(seed)
    if state is None:
        state = env.reset(batch, generator=gen)

    def draw_and_step(state):
        a = 0.3 * torch.randn(batch, env.action_size, generator=gen,
                              device=device)
        return env.step(state, a), None

    graphed = StateGraph(draw_and_step, "env_step", [gen])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def rollout(state):
        for i in range(n_steps):
            if actions is not None:
                state = env.step(state, actions[i])
            else:
                state, _ = (graphed if cuda_graphs else draw_and_step)(state)
        return state

    for _ in range(warmup):
        state = rollout(state)
    seconds, launches = [], []
    for _ in range(samples):
        before = {k: launch_counts.get(k, 0) for k in KERNELS}
        sync()
        t0 = time.perf_counter()
        state = rollout(state)
        sync()
        seconds.append(time.perf_counter() - t0)
        launches.append({k: launch_counts.get(k, 0) - before[k]
                         for k in KERNELS})
    world = mesh.world_size()
    if world > 1:
        t = torch.tensor(seconds, dtype=torch.float64,
                         device=mesh._group_device())
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
        seconds = t.tolist()
    sps = [batch * world * n_steps / s for s in seconds]
    return {**summary("stepping", sps), "cuda_graphs": cuda_graphs,
            "fused_position": env.fused_position,
            "graph": graphed.report,
            "envs": batch * world, "steps_per_sample": n_steps,
            "sample_env_steps_per_s": sps, "sample_s": seconds,
            "launches_per_sample": launches, "state": state}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=("train", "stepping"), default="train")
    p.add_argument("--envs", type=int, default=NUM_ENVS,
                   help="envs a GPU (train: a batch of envs / 32)")
    p.add_argument("--fused-position", type=int, choices=(0, 1), default=1)
    p.add_argument("--steps", type=int, default=3,
                   help="train: training steps in the measured interval")
    p.add_argument("--eager", action="store_true",
                   help="launch every kernel from the host, no CUDA graphs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("vnl_tpu_torch.bench: no CUDA device", file=sys.stderr)
        return 1
    from vnl_tpu_torch import parallel
    from vnl_tpu_torch.parallel import mesh
    if "LOCAL_RANK" in os.environ:               # torch.distributed.run
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    parallel.initialize(device="cuda")
    world = mesh.world_size()
    reset_launch_counts()
    fused = bool(args.fused_position)
    if args.mode == "stepping":
        out = run_stepping(batch=args.envs, fused_position=fused,
                           cuda_graphs=not args.eager)
        del out["state"]
    else:
        out = run(fused, args.steps, num_devices=world,
                  num_envs=args.envs * world,
                  batch_size=max(1, args.envs // 32) * world,
                  cuda_graphs=not args.eager)
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
