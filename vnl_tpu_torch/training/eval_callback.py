"""Per-evaluation callback: saves the params, runs a deterministic episode
and logs its diagnostics (PyTorch counterpart of
vnl_tpu/training/eval_callback.py).

Each call saves ``(normalizer_params, policy state_dict)`` as
``<model_path>/<num_steps>.npz``, loads that file back as the policy it
evaluates (so it evaluates exactly what it saved), and runs one episode of
``episode_length`` control steps on the raw eval env at batch 1: the mode
action drives the env, and the sampling policy with the same latent noise
gives the behaviour and uniform-action log-probs.  Diagnostics:
``diag/rtrunk_min|mean``, ``diag/episode_reward_det``,
``diag/action_mean|std``, ``diag/log_prob``, ``diag/rand_log_prob``, the
callback's own seconds ``diag/eval_callback_s``, and a PNG of the plots.
The JAX package runs the episode as one jitted scan; here it is an eager
loop on the env's device.  The overlay video waits for ``render/``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vnl_tpu_torch.models import make_inference_fn
from vnl_tpu_torch.training import checkpoint as ckpt_lib


class EvalCallback:
    def __init__(self, env, model_path: str, logger=None,
                 episode_length: int = 150, render: bool = False,
                 plots: bool = True):
        if render:
            raise NotImplementedError(
                "the overlay video needs render/, which the port does not "
                "have yet (ROADMAP.md §1, item 'Rendering'); pass "
                "render=False (render_eval: false)")
        self._env = env
        self._model_path = model_path
        self._logger = logger
        self._episode_length = episode_length
        self._plots = plots
        self._calls = 0

    def rollout(self, policy, generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, Sequence[torch.Tensor]]] = None
                ) -> Dict[str, np.ndarray]:
        """One episode of one env with ``policy`` (an IntentionPolicy).
        ``noise`` may fix the draws: ``start_frame`` (1,) and ``reset``
        (1, nq) for the reset, and per step ``latent`` (1, latent),
        ``action`` (1, nu) and ``uniform`` (1, nu); the rest come from
        ``generator``.  Returns (T, ...) numpy series."""
        noise = noise or {}
        make = make_inference_fn(policy)
        det_policy, stoch_policy = make(deterministic=True), make()
        state = self._env.reset(1, generator=generator,
                                start_frame=noise.get("start_frame"),
                                noise=noise.get("reset"))
        out = {k: [] for k in ("qpos", "rtrunk", "reward", "action",
                               "log_prob", "rand_log_prob")}
        for t in range(self._episode_length):
            traj, obs = state.info["traj"], state.obs
            latent = noise["latent"][t] if "latent" in noise else \
                torch.randn((1, policy.latent_width), generator=generator,
                            device=obs.device)
            act, _ = det_policy(traj, obs, generator, latent_noise=latent)
            _, extras = stoch_policy(
                traj, obs, generator, latent_noise=latent,
                action_noise=noise["action"][t] if "action" in noise
                else None,
                uniform=noise["uniform"][t] if "uniform" in noise else None)
            state = self._env.step(state, act)
            out["qpos"].append(state.pipeline_state.qpos[0])
            out["rtrunk"].append(state.info.get(
                "termination_error", torch.zeros(1))[0])
            out["reward"].append(state.reward[0])
            out["action"].append(act[0])
            out["log_prob"].append(extras["log_prob"][0])
            out["rand_log_prob"].append(extras["rand_log_prob"][0])
        return {k: torch.stack(v).cpu().numpy() for k, v in out.items()}

    @staticmethod
    def diagnostics(traj: Dict[str, np.ndarray]) -> Dict[str, float]:
        rtrunk = np.asarray(traj["rtrunk"], np.float64)
        rewards = np.asarray(traj["reward"], np.float64)
        actions = np.asarray(traj["action"], np.float64)
        return {
            "diag/rtrunk_min": float(rtrunk.min()),
            "diag/rtrunk_mean": float(rtrunk.mean()),
            "diag/episode_reward_det": float(rewards.sum()),
            "diag/action_mean": float(actions.mean()),
            "diag/action_std": float(actions.std()),
            "diag/log_prob": float(np.mean(traj["log_prob"])),
            "diag/rand_log_prob": float(np.mean(traj["rand_log_prob"])),
        }

    def __call__(self, num_steps: int, params) -> dict:
        """Saves ``params`` (normalizer_params, policy state_dict),
        evaluates them, logs and returns the diagnostics."""
        t0 = time.perf_counter()
        device = self._env.sys.device
        path = ckpt_lib.save_params(
            os.path.join(self._model_path, str(num_steps)), params)
        policy = ckpt_lib.load_params(path, device=device)
        gen = torch.Generator(device=device).manual_seed(self._calls)
        traj = self.rollout(policy, gen)
        series = self.diagnostics(traj)
        if self._plots:
            try:
                series["diag/plots"] = self._render_plots(traj, num_steps)
            except Exception as e:  # plotting must never kill training
                series["diag/plots_error"] = str(e)
        series["diag/eval_callback_s"] = time.perf_counter() - t0
        if self._logger is not None:
            self._logger.log(series, step=num_steps)
        self._calls += 1
        return series

    def _render_plots(self, traj, num_steps: int) -> str:
        """Per-actuator action mean/std across the episode, the reward
        curve, the rtrunk curve, behaviour-vs-random log-prob curves: one
        PNG in the run dir."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        actions = np.asarray(traj["action"], np.float64)
        t = np.arange(actions.shape[0])
        fig, axes = plt.subplots(2, 2, figsize=(11, 7))

        ax = axes[0][0]
        mean, std = actions.mean(axis=0), actions.std(axis=0)
        idx = np.arange(actions.shape[1])
        ax.bar(idx, mean, yerr=std, color="#4c72b0", ecolor="#aaaaaa")
        ax.set_title("per-actuator action mean ± std")
        ax.set_xlabel("actuator")

        ax = axes[0][1]
        ax.plot(t, np.asarray(traj["reward"]), label="reward")
        ax.set_title("reward per step (deterministic rollout)")
        ax.set_xlabel("t")
        ax.legend()

        ax = axes[1][0]
        ax.plot(t, np.asarray(traj["rtrunk"]), color="#c44e52")
        ax.set_title("rtrunk (termination error)")
        ax.set_xlabel("t")

        ax = axes[1][1]
        ax.plot(t, np.asarray(traj["log_prob"]), label="log_prob")
        ax.plot(t, np.asarray(traj["rand_log_prob"]), label="rand_log_prob")
        ax.legend()
        ax.set_title("behaviour vs random log-prob")
        ax.set_xlabel("t")

        fig.suptitle(f"eval diagnostics @ {num_steps:,} steps")
        fig.tight_layout()
        out = os.path.join(self._model_path, f"diag_{num_steps}.png")
        fig.savefig(out, dpi=100)
        plt.close(fig)
        return out
