"""Humanoid-tracking learning run of the port (the counterpart of
tools/run_humanoid_tpu.py and tools/run_humanoid_cpu.py).

Trains ``HumanoidTracking`` on its built-in static clip (the committed
dm_control humanoid's first keyframe) with the tools' hyperparameters:
on ``cuda`` the TPU tool's (30M env steps, 1024 envs, 256 eval envs,
batch 32 x 32 minibatches, 8 passes, 15 evaluations), on ``cpu`` the CPU
tool's (3M env steps, 128 envs, 64 eval envs, a batch of envs / 32, 16
evaluations).  On a CUDA device the control step, the SGD update and the
evaluations' control steps replay CUDA graphs (``train``'s default).

  python -m vnl_tpu_torch.run_humanoid [num_timesteps] [num_envs]
      [--device cuda|cpu] [--out DIR]

Writes the metrics JSONL (``metrics_humanoid.jsonl``, one row an
evaluation) and the curve PNG (``curve_humanoid.png``: the eval reward and
the episode length; a bare numpy plot where matplotlib is missing) under
``--out`` (default ``build/run_humanoid``); prints the tools' line for
each evaluation and their "first eval reward -> best" line, then one JSON
line, {"run_humanoid": ...}, with the curve, env-steps/s, the wall time
and, on a CUDA device, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vnl_tpu_torch.ops import build
from vnl_tpu_torch.physics.forward import pin_fp32

OUT = os.path.join("build", "run_humanoid")

# the tools' defaults: num_timesteps, num_envs
DEFAULTS = {"cuda": (30_000_000, 1024), "cpu": (3_000_000, 128)}


def train_kwargs(device: str, num_timesteps: Optional[int] = None,
                 num_envs: Optional[int] = None) -> Dict:
    """The ``train(...)`` arguments of the tool of ``device``'s kind
    (tools/run_humanoid_tpu.py:42-49 on ``cuda``,
    tools/run_humanoid_cpu.py:44-51 on ``cpu``), progress_fn aside."""
    kind = torch.device(device).type
    steps, envs = DEFAULTS["cuda" if kind == "cuda" else "cpu"]
    steps = steps if num_timesteps is None else num_timesteps
    envs = envs if num_envs is None else num_envs
    kw = dict(num_timesteps=steps, episode_length=150, num_envs=envs,
              learning_rate=6e-4, entropy_cost=1e-3, discounting=0.99,
              unroll_length=20, num_minibatches=32, num_updates_per_batch=8,
              normalize_observations=True, reward_scaling=1.0,
              clipping_epsilon=0.2, gae_lambda=0.95, kl_weight=1e-4, seed=0)
    if kind == "cuda":
        kw.update(num_eval_envs=256, batch_size=32, num_evals=15)
    else:
        kw.update(num_eval_envs=64, batch_size=envs // 32 or 1, num_evals=16)
    return kw


def progress_line(step: int, metrics: Dict, with_sps: bool) -> str:
    """The tools' line for one evaluation (the TPU tool's adds sps)."""
    line = (f"[{step:>10}] reward="
            f"{metrics.get('eval/episode_reward', float('nan')):.4f} "
            f"len={metrics.get('eval/avg_episode_length', float('nan')):.1f}")
    if with_sps:
        line += f" sps={metrics.get('training/sps', float('nan')):.0f}"
    return line


def write_curve(path: str, evals: List[Dict]) -> str:
    """The eval reward and the episode length against env steps."""
    xs = [r["step"] for r in evals]
    ys = [r["eval/episode_reward"] for r in evals]
    ls = [r.get("eval/avg_episode_length", float("nan")) for r in evals]
    try:
        import matplotlib
    except ImportError:
        from vnl_tpu_torch.utils.images import plot_png
        return plot_png(path, [(ys, (31, 119, 180)), (ls, (255, 127, 14))])
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(1, 2, figsize=(10, 4))
    ax[0].plot(xs, ys, marker="o")
    ax[0].set_xlabel("env steps")
    ax[0].set_ylabel("eval episode reward")
    ax[1].plot(xs, ls, marker="o", color="tab:orange")
    ax[1].set_xlabel("env steps")
    ax[1].set_ylabel("avg episode length")
    fig.suptitle("HumanoidTracking (built-in static clip, vnl_tpu_torch)")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def run(num_timesteps: Optional[int] = None, num_envs: Optional[int] = None,
        device="cuda", out: str = OUT, **overrides) -> Dict:
    """Trains (``overrides`` replace arguments of ``train``), writes the
    JSONL and the PNG under ``out`` and returns the run's record: the
    curve, the rates, the graphs' captures (utils/graphs.py reports) and
    the trained (normaliser, policy state_dict) under ``params``."""
    from vnl_tpu_torch import training
    from vnl_tpu_torch.envs import HumanoidTracking
    from vnl_tpu_torch.training.train import _sync
    from vnl_tpu_torch.utils import graphs
    captures = len(graphs.REPORTS)
    os.makedirs(out, exist_ok=True)
    metrics_path = os.path.join(out, "metrics_humanoid.jsonl")
    open(metrics_path, "w").close()
    with_sps = torch.device(device).type == "cuda"
    rows: List[Dict] = []

    def progress(step, metrics):
        row = {"step": int(step),
               **{k: float(v) for k, v in metrics.items()
                  if isinstance(v, (int, float, np.floating))}}
        rows.append(row)
        with open(metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(progress_line(step, metrics, with_sps), flush=True)

    kw = dict(train_kwargs(device, num_timesteps, num_envs), **overrides)
    env = HumanoidTracking(device=device)
    t0 = time.perf_counter()
    _, params, _ = training.train(env, progress_fn=progress, device=device,
                                  **kw)
    _sync(device)
    wall = time.perf_counter() - t0
    evals = [r for r in rows if "eval/episode_reward" in r]
    first = evals[0]["eval/episode_reward"]
    best = max(r["eval/episode_reward"] for r in evals)
    print(f"first eval reward {first:.4f} -> best {best:.4f}", flush=True)
    png = write_curve(os.path.join(out, "curve_humanoid.png"), evals)
    print(f"curve written {png}", flush=True)
    sps = [r["training/sps"] for r in rows if "training/sps" in r]
    steps = rows[-1]["step"] if rows else 0
    return dict(
        curve=[[r["step"], r["eval/episode_reward"],
                r.get("eval/avg_episode_length")] for r in evals],
        first_reward=first, best_reward=best,
        last_reward=evals[-1]["eval/episode_reward"], env_steps=steps,
        wall_s=wall, env_steps_per_s=steps / wall if wall else None,
        training_env_steps_per_s_median=(float(np.median(sps)) if sps
                                         else None),
        eval_s=[r.get("eval/epoch_eval_time") for r in evals],
        graphs=graphs.REPORTS[captures:], metrics=metrics_path, png=png,
        train_kwargs={k: v for k, v in kw.items()
                      if isinstance(v, (int, float, str, bool))},
        params=params)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("num_timesteps", nargs="?", type=int)
    p.add_argument("num_envs", nargs="?", type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            p.error("no CUDA device (use --device cpu)")
        build.build_all()
        pin_fp32()
    rec = run(args.num_timesteps, args.num_envs, args.device, args.out)
    rec.pop("params")
    if cuda:
        from vnl_tpu_torch.bench import gpu_name_and_power_limit
        rec["device"] = torch.cuda.get_device_name(0)
        rec["name_and_power_limit"] = gpu_name_and_power_limit()
    else:
        rec["device"] = "cpu"
    print(json.dumps({"run_humanoid": rec}), flush=True)
    return rec


if __name__ == "__main__":
    main()
