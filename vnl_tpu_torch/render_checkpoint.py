"""Renders a rollout of a saved policy (PyTorch counterpart of
tools/render_checkpoint.py).

Rolls the deterministic policy on one eval-convention env (start frame 0,
the whole clip) for up to clip_length - ref_traj_length - 1 control steps,
stopping at ``done``, and writes the agent-vs-reference ghost overlay
video (``<out>.mp4``; a ``.gif`` where imageio has no mp4 backend or is
missing) and the reward / rtrunk plot ``<out>_diag.png`` (matplotlib's
figure where it imports, else a bare numpy plot of the same two panels).

  python -m vnl_tpu_torch.render_checkpoint [ckpt] [out_prefix]
      [--skin path.skn] [--device cpu] [--config <env yaml>]

``ckpt`` is a params file, a full-state checkpoint or an exported JAX one
(as for vnl_tpu_torch.eval_checkpoint); by default the newest params file
under ``model_checkpoints/<run>/``.  ``out_prefix`` defaults to
``rollout`` in the temporary directory.  The env, the policy and the
renderer run on ``cuda`` unless ``--device cpu``.  Prints one
``{"render_checkpoint": ...}`` JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from vnl_tpu_torch import eval_checkpoint
from vnl_tpu_torch.render.software import overlay_frames, write_video
from vnl_tpu_torch.train import build_env
from vnl_tpu_torch.training.eval_callback import EvalCallback
from vnl_tpu_torch.training.train import _sync
from vnl_tpu_torch.utils import load_config

RENDER_SEED = 0     # the JAX tool's PRNGKey(0)


def newest_checkpoint(root: str = "model_checkpoints") -> Optional[str]:
    """The newest ``<steps>.npz`` params file under ``root/<run>/``."""
    best, best_mtime = None, -1.0
    for run in sorted(os.listdir(root)):
        d = os.path.join(root, run)
        if not os.path.isdir(d):
            continue
        for name in os.listdir(d):
            if name.endswith(".npz") and name[:-4].isdigit():
                p = os.path.join(d, name)
                if os.path.getmtime(p) > best_mtime:
                    best, best_mtime = p, os.path.getmtime(p)
    return best


def rollout(params_or_path, cfg: Optional[Dict] = None, device="cuda",
            steps: Optional[int] = None, noise: Optional[Dict] = None):
    """The deterministic episode (EvalCallback.rollout, stopping at done)
    of up to ``steps`` control steps on the eval env; returns (its
    series, the callback, which also gives the overlay's inputs).
    ``noise`` fixes the draws as EvalCallback.rollout takes them; else
    they come from a generator seeded with 0.  On a CUDA device each
    control step is a replay of a CUDA graph; the CPU steps eagerly."""
    cfg = cfg if cfg is not None else load_config(eval_checkpoint.TWIN_CONFIG)
    policy, _, _ = eval_checkpoint.load_policy(params_or_path, device)
    env = build_env(cfg, for_eval=True, device=device)
    args = cfg["env"]["env_args"]
    steps = steps or (args["clip_length"] - args.get("ref_traj_length", 5)
                      - 1)
    cb = EvalCallback(env, model_path="", episode_length=steps, plots=False)
    gen = torch.Generator(device=device).manual_seed(RENDER_SEED)
    return cb.rollout(policy, gen, noise, stop_at_done=True), cb


def write_diag(path: str, rewards, rtrunk) -> str:
    """The per-step reward and rtrunk panels as a PNG."""
    try:
        import matplotlib
    except ImportError:
        from vnl_tpu_torch.utils.images import plot_png
        return plot_png(path, [(rewards, (47, 111, 214)),
                               (rtrunk, (26, 138, 122))])
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(7, 5), sharex=True)
    ax1.plot(rewards, color="#2f6fd6", linewidth=2)
    ax1.set_title("per-step reward (deterministic policy)", loc="left",
                  fontsize=11)
    ax2.plot(rtrunk, color="#1a8a7a", linewidth=2)
    ax2.set_title("rtrunk (1 - tracking error / threshold)", loc="left",
                  fontsize=11)
    ax2.set_xlabel("step")
    for ax in (ax1, ax2):
        ax.grid(True, color="#e4e6ea", linewidth=0.8)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def render(params_or_path, out_prefix: str, cfg: Optional[Dict] = None,
           device="cuda", skin="auto", steps: Optional[int] = None,
           noise: Optional[Dict] = None) -> Dict:
    """:func:`rollout`, the diag PNG and the overlay video (``skin``: a
    .skn path, a render.skin.Skin, "auto" for the model's own or None).
    Returns the series, the paths, the overlay frames (a uint8 tensor on
    the device) and the seconds of the rollout (its graph's capture
    included, ``capture_s``) and of the overlay."""
    t0 = time.perf_counter()
    traj, cb = rollout(params_or_path, cfg, device, steps, noise)
    rollout_s = time.perf_counter() - t0
    diag = write_diag(out_prefix + "_diag.png", traj["reward"],
                      traj["rtrunk"])
    qa, qr = cb.overlay_inputs(traj["qpos"], traj["start_frame"],
                               traj["clip_id"])
    _sync(device)
    t0 = time.perf_counter()
    frames = overlay_frames(cb._env.sys, qa, qr, skin=skin, device=device)
    _sync(device)
    render_s = time.perf_counter() - t0
    video = write_video(frames.cpu().numpy(), out_prefix + ".mp4")
    return dict(traj=traj, diag=diag, video=video, frames=frames,
                rollout_s=rollout_s, capture_s=cb.capture_s,
                render_s=render_s)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", nargs="?")
    p.add_argument("out_prefix", nargs="?",
                   default=os.path.join(tempfile.gettempdir(), "rollout"))
    p.add_argument("--skin", default="auto",
                   help="a .skn file (default: the model's own skin, if any)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default=eval_checkpoint.TWIN_CONFIG,
                   help="env config (default: the rodent twin's)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    ckpt = (os.path.abspath(args.checkpoint) if args.checkpoint
            else newest_checkpoint())
    if ckpt is None:
        p.error("no checkpoint given and none under model_checkpoints/")
    print("checkpoint:", ckpt, flush=True)
    out = render(ckpt, args.out_prefix, load_config(args.config),
                 args.device, args.skin)
    rewards, rtrunk = out["traj"]["reward"], out["traj"]["rtrunk"]
    n = len(rewards)
    print(f"rolled {n} steps; mean reward {np.mean(rewards):.4f}; final "
          f"rtrunk {rtrunk[-1]:.4f}", flush=True)
    print("wrote", out["diag"], flush=True)
    print("wrote", out["video"], flush=True)
    rec = dict(checkpoint=ckpt, steps=n, reward_mean=float(np.mean(rewards)),
               final_rtrunk=float(rtrunk[-1]), diag=out["diag"],
               video=out["video"], frames=int(out["frames"].shape[0]),
               rollout_s=out["rollout_s"], capture_s=out["capture_s"],
               render_s=out["render_s"],
               ms_per_frame=1e3 * out["render_s"] / out["frames"].shape[0],
               skin=args.skin, device=eval_checkpoint.device_name(
                   args.device))
    print(json.dumps({"render_checkpoint": rec}), flush=True)
    return rec


if __name__ == "__main__":
    main()
