"""Explore the rodent tracking env: a random-action rollout and its
termination-error curve (PyTorch counterpart of examples/rollout_rodent.py,
on the rodent twin).

Builds RodentTracking from vnl_tpu_torch/configs/rodent_twin_config.yaml
(the training convention), drives one env for 50 control steps with
actions drawn as 0.3 x N(0, 1), and prints the termination-error curve as
a smooth-divergence check; ``--plot`` writes it as a PNG, ``--render`` the
agent-vs-reference overlay video, both into ``--out-dir`` (default: the
temporary directory).  Runs on ``cuda`` unless ``--device cpu``; run from
the repo root (the config's paths are relative to it).

  python -m vnl_tpu_torch.examples.rollout_rodent [--render] [--plot]
      [--device cpu] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from vnl_tpu_torch.eval_checkpoint import TWIN_CONFIG
from vnl_tpu_torch.train import build_env
from vnl_tpu_torch.utils import load_config


def main(render: bool = False, plot: bool = False, device="cuda",
         steps: int = 50, out_dir: str = tempfile.gettempdir(),
         cfg=None) -> dict:
    env = build_env(cfg or load_config(TWIN_CONFIG), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = env.reset(1, generator=gen)
    print(f"obs={tuple(state.obs.shape[1:])} "
          f"traj={tuple(state.info['traj'].shape[1:])} init "
          f"termination_error="
          f"{float(state.info['termination_error'][0]):.4f}")

    qpos_traj, term_err = [], []
    for t in range(steps):
        action = 0.3 * torch.randn((1, env.action_size), generator=gen,
                                   device=device)
        state = env.step(state, action)
        qpos_traj.append(state.pipeline_state.qpos[0])
        term_err.append(state.metrics["termination_error"][0])
        if t % 10 == 9:
            print(f"t={t + 1:3d} reward={float(state.reward[0]):.5f} "
                  f"rtrunk={float(term_err[-1]):.4f} "
                  f"done={float(state.done[0]):.0f}")
    qpos_traj = torch.stack(qpos_traj).cpu().numpy()
    term_err = torch.stack(term_err).cpu().numpy()
    print("termination_error curve (should diverge smoothly):")
    print(np.array2string(term_err[:20], precision=3))
    out = {"termination_error": term_err, "qpos": qpos_traj}

    if plot:
        out["plot"] = os.path.join(out_dir, "rodent_termination_error.png")
        try:
            import matplotlib
        except ImportError:
            from vnl_tpu_torch.utils.images import plot_png
            plot_png(out["plot"], [(term_err, (31, 119, 180))], height=350)
        else:
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(6, 3.5))
            ax.plot(term_err)
            ax.axhline(1.0, ls="--", lw=1, label="done threshold (rtrunk<0)")
            ax.set_xlabel("step")
            ax.set_ylabel("termination error")
            ax.set_title("random-action rollout divergence (sigma=0.3)")
            ax.legend()
            fig.tight_layout()
            fig.savefig(out["plot"], dpi=120)
            plt.close(fig)
        print("wrote", out["plot"])

    if render:
        from vnl_tpu_torch.render import render_overlay_video
        ref, n = env.reference_clip, len(qpos_traj)
        qref = torch.cat([ref.position[:n], ref.quaternion[:n],
                          ref.joints[:n]], 1).cpu().numpy()
        out["video"] = render_overlay_video(
            env.sys, qpos_traj, qref,
            os.path.join(out_dir, "rodent_rollout.mp4"))
        print("wrote", out["video"])
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--render", action="store_true")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out-dir", default=tempfile.gettempdir())
    a = p.parse_args(sys.argv[1:])
    main(a.render, a.plot, a.device, out_dir=a.out_dir)
