"""Multi-clip rodent imitation training (PyTorch counterpart of
examples/train_multiclip.py, on the rodent twin).

The twin, compiled by the port's MJCF compiler (``compile_rodent``), turns
its 250-frame clip into a ClipLibrary of two 125-frame clips
(``process_recording``); RodentMultiClipTracking draws a clip id an
episode, and ``training.train`` runs at the example's own sizes (32 envs,
batch 16 x 4 minibatches, 2 passes, 3 evaluations).  Runs on ``cuda``
unless ``--device cpu``; run from the repo root.

  python -m vnl_tpu_torch.examples.train_multiclip [num_timesteps]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from vnl_tpu_torch import envs, training
from vnl_tpu_torch.data import load_clip, process_recording
from vnl_tpu_torch.eval_checkpoint import TWIN_CONFIG
from vnl_tpu_torch.utils import load_config

TRAIN_KW = dict(episode_length=50, num_envs=32, num_eval_envs=16,
                learning_rate=6e-4, entropy_cost=1e-3, discounting=0.99,
                unroll_length=10, batch_size=16, num_minibatches=4,
                num_updates_per_batch=2, num_evals=3,
                normalize_observations=True, clipping_epsilon=0.2,
                kl_weight=1e-4, seed=0)


def main(num_timesteps: int = 200_000, device="cuda", env_overrides=None,
         **train_overrides):
    """Builds the library and the env and trains; ``env_overrides`` go to
    the env, ``train_overrides`` replace arguments of ``training.train``.
    Returns (make_policy, params, metrics) as ``train`` does."""
    cfg = load_config(TWIN_CONFIG)["env"]
    args = dict(cfg["env_args"])
    model = envs.compile_rodent(args["mjcf_path"],
                                scale_factor=args["scale_factor"],
                                device=device)
    clip = load_clip(cfg["clip_path"], device=device)
    qpos = torch.cat([clip.position, clip.quaternion, clip.joints], 1)
    lib = process_recording(model, qpos.cpu().numpy(), clip_length=125)

    args.update(clip_length=125, sub_clip_length=10, ref_traj_length=5,
                device=device, **(env_overrides or {}))
    env = envs.get_environment("rodent_multiclip", clip_library=lib, **args)
    out = training.train(env, num_timesteps=num_timesteps, device=device,
                         **dict(TRAIN_KW, **train_overrides))
    print({k: round(float(v), 4) for k, v in out[2].items()
           if "episode_reward" in k or "sps" in k})
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("num_timesteps", nargs="?", type=int, default=200_000)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(sys.argv[1:])
    main(a.num_timesteps, a.device)
