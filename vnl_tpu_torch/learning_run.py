"""A learning run of the training command line on the rodent twin, resumed
once, with the deterministic evaluation of its checkpoints.

  python -m vnl_tpu_torch.learning_run --out DIR [--work DIR]
      [--num-envs 1024] [--timesteps 4915200] [--eval-every 378000]
      [--resume-timesteps 6144000] [--resume-eval-every 384000]
      [--eval-envs 64] [--eval-length N] [--device cuda]

1. ``python -m vnl_tpu_torch.train`` (``main``) with
   vnl_tpu_torch/configs/rodent_twin_config.yaml at the config's
   hyperparameters but ``train.num_envs``, ``train.num_timesteps`` and
   ``train.eval_every`` (at 20,480 env steps a training step, the defaults
   give 12 intervals of 20 training steps);
2. the seconds to restore its last full-state checkpoint and to save it
   again (``training/checkpoint.py``);
3. the same command line resumed from that checkpoint to
   ``--resume-timesteps`` (absolute; the defaults add 3 intervals of 20);
4. ``vnl_tpu_torch.eval_checkpoint.evaluate`` with ``--eval-envs`` envs on
   the first and the last params file of leg 1 and the last of leg 2.

Checkpoints go under ``--work`` (default ``build/learning_run``); the
metrics JSONL of both legs and the three evaluated params files go under
``--out``.  The resumed leg logs its first evaluation (of the restored
policy) at step 0; the curve puts it at the restored env steps.  The last line is one ``{"learning_run":
...}`` JSON object: the in-loop curve (``eval/episode_reward``,
``eval/avg_episode_length``, ``training/sps`` by env step) of both legs,
env-steps/s, the save and restore seconds, the deterministic evaluations
and the card's name and power limit.  Run from the repo root (the config's
paths are relative to it).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from vnl_tpu_torch import eval_checkpoint
from vnl_tpu_torch import train as cli
from vnl_tpu_torch.training import checkpoint
from vnl_tpu_torch.training.train import _sync
from vnl_tpu_torch.utils import apply_overrides, load_config

CURVE_KEYS = ("eval/episode_reward", "eval/avg_episode_length",
              "training/sps")


def run_leg(tag, args, extra):
    """One command-line run; returns (run dir, its metrics records)."""
    ck, logs = os.path.join(args.work, tag), os.path.join(args.out, tag)
    shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(logs, ignore_errors=True)
    cli.main([f"env_config={eval_checkpoint.TWIN_CONFIG}",
              f"train.num_envs={args.num_envs}",
              f"train.checkpoint_dir={ck}", f"train.log_dir={logs}"] + extra,
             device=args.device)
    (run,) = glob.glob(os.path.join(ck, "*"))
    (path,) = glob.glob(os.path.join(logs, "metrics_*.jsonl"))
    with open(path) as f:
        records = [json.loads(line) for line in f][1:]
    return run, records


def curve(records, start=0):
    """[(env step, reward, length, env-steps/s or None)] of the
    evaluation records; the one logged at step 0 is at ``start``."""
    return [[r["_step"] or start] + [r.get(k) for k in CURVE_KEYS]
            for r in records if "eval/episode_reward" in r]


def params_files(run):
    """The run's params files by step (the eval callback's)."""
    steps = sorted(int(n[:-4]) for n in os.listdir(run)
                   if n.endswith(".npz") and n[:-4].isdigit())
    return [os.path.join(run, f"{s}.npz") for s in steps]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--work", default=os.path.join("build", "learning_run"))
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--timesteps", type=int, default=4_915_200)
    p.add_argument("--eval-every", type=int, default=378_000)
    p.add_argument("--resume-timesteps", type=int, default=6_144_000)
    p.add_argument("--resume-eval-every", type=int, default=384_000)
    p.add_argument("--eval-envs", type=int, default=64)
    p.add_argument("--eval-length", type=int, default=None,
                   help="control steps an evaluation (default: the clip)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--extra", nargs="*", default=[],
                   help="more overrides for both legs (key=value)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    os.makedirs(args.out, exist_ok=True)
    rep = {"num_envs": args.num_envs}
    if torch.device(args.device).type == "cuda":
        from vnl_tpu_torch.bench import gpu_name_and_power_limit
        rep["card"] = gpu_name_and_power_limit()

    t0 = time.perf_counter()
    run1, rec1 = run_leg("leg1", args, [
        f"train.num_timesteps={args.timesteps}",
        f"train.eval_every={args.eval_every}"] + args.extra)
    rep["leg1_s"] = time.perf_counter() - t0
    state = checkpoint.latest_checkpoint(os.path.join(run1, "state"))

    _sync(args.device)
    t0 = time.perf_counter()
    ts = checkpoint.restore(state, device=args.device)
    _sync(args.device)
    rep["restore_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint.save(os.path.join(args.work, "save_timing"), ts.env_steps, ts)
    rep["save_s"] = time.perf_counter() - t0
    rep["state_bytes"] = os.path.getsize(state)

    t0 = time.perf_counter()
    run2, rec2 = run_leg("leg2", args, [
        f"train.num_timesteps={args.resume_timesteps}",
        f"train.eval_every={args.resume_eval_every}",
        f"train.restore_checkpoint={state}"] + args.extra)
    rep["leg2_s"] = time.perf_counter() - t0
    rep["resumed_from"] = ts.env_steps

    for leg, records, start in (("leg1", rec1, 0),
                                ("leg2", rec2, ts.env_steps)):
        rep[f"{leg}_curve"] = curve(records, start)
        sps = [r["training/sps"] for r in records if "training/sps" in r]
        # the first interval of a leg includes the kernels' first launches
        rep[f"{leg}_env_steps_per_s"] = sps
        rep[f"{leg}_env_steps_per_s_median_after_first"] = (
            float(np.median(sps[1:])) if len(sps) > 1 else None)

    cfg = apply_overrides(load_config(eval_checkpoint.TWIN_CONFIG),
                          [a for a in args.extra if a.startswith("env.")])
    files1, files2 = params_files(run1), params_files(run2)
    rep["deterministic_eval"] = {}
    for tag, path in (("leg1_first", files1[0]), ("leg1_last", files1[-1]),
                      ("leg2_last", files2[-1])):
        shutil.copy(path, os.path.join(args.out, f"{tag}.npz"))
        res = eval_checkpoint.evaluate(path, args.eval_envs, cfg,
                                       args.device, args.eval_length)
        rec = eval_checkpoint.report(res, os.path.relpath(path),
                                     args.device)
        rec["params_step"] = int(os.path.basename(path)[:-4])
        print(json.dumps({"eval_checkpoint": rec}), flush=True)
        rep["deterministic_eval"][tag] = rec
    print(json.dumps({"learning_run": rep}), flush=True)
    return rep


if __name__ == "__main__":
    main()
