"""Low-noise deterministic evaluation of a saved policy (PyTorch
counterpart of tools/eval_checkpoint.py).

The trainer's in-loop evaluation acts with the stochastic policy, which
carries about +-0.15 reward and +-15 steps of length between intervals.
This reports the deterministic policy (the action at the distribution's
mode; the intention latent is still drawn) over N seeded full-clip
episodes: one number per checkpoint, comparable across checkpoints.

  python -m vnl_tpu_torch.eval_checkpoint <ckpt> [n_envs] [--device cpu]
      [--config <env yaml>]

``<ckpt>`` is a params file (``<run>/<steps>.npz``, ``finished.npz``), a
full-state checkpoint (``<run>/state/<steps>.npz``), or a JAX checkpoint
flattened by ``tools/export_torch_assets.py --checkpoint``.  The env is the
eval convention of the training command line (``train.build_env(cfg,
for_eval=True)``: start frame 0, the whole clip, no curriculum), on the
committed rodent twin by default.  Paths inside the config are relative
to the working directory (the repo root).  Prints the reward and length
statistics and one ``{"eval_checkpoint": ...}`` JSON line.  Runs on
``cuda`` unless ``--device cpu``; there each control step of the episodes
is one CUDA graph replay (training.acting.Evaluator), and the record's
``seconds`` include the graph's capture, ``capture_s``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from vnl_tpu_torch.envs.wrappers import wrap_for_training
from vnl_tpu_torch.models import make_inference_fn
from vnl_tpu_torch.train import CONFIGS, build_env
from vnl_tpu_torch.training import checkpoint as ckpt_lib
from vnl_tpu_torch.training.acting import Evaluator
from vnl_tpu_torch.utils import load_config

TWIN_CONFIG = os.path.join(CONFIGS, "rodent_twin_config.yaml")
EVAL_SEED = 7      # the JAX tool's PRNGKey(7)


def load_policy(params_or_path, device="cuda"):
    """(policy, env_steps or None, seconds to read it) of a checkpoint
    path, or of an IntentionPolicy given as it is."""
    if not isinstance(params_or_path, (str, os.PathLike)):
        return params_or_path.to(device), None, 0.0
    t0 = time.perf_counter()
    policy, env_steps = ckpt_lib.load_policy(os.fspath(params_or_path),
                                             device=device)
    return policy, env_steps, time.perf_counter() - t0


def evaluate(params_or_path, n_envs: int = 16, cfg: Optional[Dict] = None,
             device="cuda", episode_length: Optional[int] = None,
             noise: Optional[Dict] = None,
             cuda_graphs: Optional[bool] = None) -> Dict:
    """The deterministic policy over ``n_envs`` eval-convention episodes of
    ``episode_length`` control steps (default: the whole clip,
    clip_length - ref_traj_length).  ``cfg`` holds the env group
    (default: the twin's config).  ``noise`` fixes the reset and latent
    draws (Evaluator.run_evaluation); otherwise they come from a
    generator seeded with 7.  ``cuda_graphs`` (None: on a CUDA device)
    replays each control step as a CUDA graph (Evaluator).  Returns
    per-episode ``rewards`` and ``lengths`` (numpy), ``horizon``,
    ``env_steps`` (None for a params file), ``seconds`` of the evaluation
    (the graph's capture included), ``capture_s``, ``load_s`` and the
    ``evaluator`` (its graphs can be replayed again)."""
    cfg = cfg if cfg is not None else load_config(TWIN_CONFIG)
    policy, env_steps, load_s = load_policy(params_or_path, device)
    env = build_env(cfg, for_eval=True, device=device)
    env_args = cfg["env"]["env_args"]
    horizon = env_args["clip_length"] - env_args.get("ref_traj_length", 5)
    episode_length = episode_length or horizon
    evaluator = Evaluator(
        wrap_for_training(env, episode_length=episode_length),
        make_inference_fn(policy)(deterministic=True),
        num_eval_envs=n_envs, episode_length=episode_length,
        action_repeat=1,
        generator=torch.Generator(device=device).manual_seed(EVAL_SEED),
        cuda_graphs=cuda_graphs)
    out = evaluator.run_evaluation({}, aggregate_episodes=False,
                                   noise=noise)
    return dict(rewards=np.asarray(out["eval/episode_reward"]),
                lengths=np.asarray(out["eval/episode_length"]),
                horizon=episode_length, n_envs=n_envs, env_steps=env_steps,
                seconds=out["eval/epoch_eval_time"],
                capture_s=evaluator.capture_s, load_s=load_s,
                evaluator=evaluator)


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def report(res: Dict, checkpoint: Union[str, None], device) -> Dict:
    """Prints the JAX tool's two lines and returns the JSON record."""
    rew, lengths, h = res["rewards"], res["lengths"], res["horizon"]
    print(f"deterministic eval over {res['n_envs']} full-clip episodes "
          f"(horizon {h}):", flush=True)
    print(f"  reward  mean={rew.mean():.3f}  median={np.median(rew):.3f}  "
          f"min={rew.min():.3f}  max={rew.max():.3f}")
    print(f"  length  mean={lengths.mean():.1f} of {h}")
    return dict(checkpoint=checkpoint, env_steps=res["env_steps"],
                n_envs=res["n_envs"], horizon=h,
                reward_mean=float(rew.mean()),
                reward_median=float(np.median(rew)),
                reward_min=float(rew.min()), reward_max=float(rew.max()),
                length_mean=float(lengths.mean()),
                rewards=rew.tolist(), lengths=lengths.tolist(),
                seconds=res["seconds"], capture_s=res["capture_s"],
                load_s=res["load_s"],
                device=device_name(device))


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint")
    p.add_argument("n_envs", nargs="?", type=int, default=16)
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default=TWIN_CONFIG,
                   help="env config (default: the rodent twin's)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    path = os.path.abspath(args.checkpoint)
    res = evaluate(path, args.n_envs, load_config(args.config), args.device)
    if res["env_steps"] is not None:
        print(f"TrainingState at env_steps={res['env_steps']}", flush=True)
    rec = report(res, path, args.device)
    print(json.dumps({"eval_checkpoint": rec}), flush=True)
    return rec


if __name__ == "__main__":
    main()
