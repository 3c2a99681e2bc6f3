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
The JAX package runs the episode as one jitted scan; here, with
``cuda_graphs`` (None: on a CUDA device; True on the CPU raises), each of
its control steps is one replay of a CUDA graph (envs.StateGraph), captured
at the first call and replayed by every later one; the reset stays eager.
The draws of call n come from one generator of the callback, reseeded
with n.  The CPU runs the same steps eagerly.

With ``render`` (every ``render_every``-th call) the agent-vs-reference
ghost overlay video ``<model_path>/rollout_<steps>.mp4`` (a .gif where
imageio has no mp4 backend) is rendered on the env's device by
render.render_overlay_video, on one worker thread, so that it overlaps the
next training interval; on a CUDA device the thread casts on a stream of
its own, not behind the trainer's launches on the default stream.  A call
whose predecessor's video is still being rendered skips its own
(``diag/video_skipped``).  A render error becomes the job's result
(``render-error: ...``) and training goes on, as in the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import copy
import functools
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from vnl_tpu_torch.envs.base import State, StateGraph
from vnl_tpu_torch.models import make_inference_fn
from vnl_tpu_torch.training import checkpoint as ckpt_lib
from vnl_tpu_torch.utils import graphs


class EvalCallback:
    def __init__(self, env, model_path: str, logger=None,
                 episode_length: int = 150, render_every: int = 1,
                 render: bool = False, plots: bool = True,
                 cuda_graphs: Optional[bool] = None):
        self._env = env
        self._model_path = model_path
        self._logger = logger
        self._episode_length = episode_length
        self._render_every = render_every
        self._render = render
        self._plots = plots
        self._calls = 0
        self._cuda_graphs = graphs.enabled(cuda_graphs, env.sys.device,
                                           "EvalCallback")
        self._generator = None      # every call's, reseeded with the call
        self._policy = None         # the graphs' own copy of the policy
        self._graphs = {}           # by (noise kinds, generator)
        self._render_pool = None
        self._render_stream = None
        self._pending_render = None
        if render:
            self._render_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
            device = env.sys.device
            if device.type == "cuda":
                self._render_stream = torch.cuda.Stream(device)

    @property
    def graphs(self) -> List[StateGraph]:
        """The episode graphs made so far (one a kind of noise and
        generator)."""
        return [g for g, _, _ in self._graphs.values()]

    @property
    def capture_s(self) -> float:
        """Seconds of the episode graphs' captures and instantiations."""
        return graphs.capture_s(self.graphs)

    def _step(self, det_policy, stoch_policy, latent_width: int,
              generator: Optional[torch.Generator],
              noise: Dict[str, torch.Tensor], state: State):
        """One control step of the episode: the deterministic and the
        sampling policy on the same latent, then ``env.step`` with the
        mode action.  ``noise`` holds the step's given draws (``latent``,
        ``action``, ``uniform``); the others come from ``generator``.
        Returns the next state and the step's series."""
        traj, obs = state.info["traj"], state.obs
        latent = noise.get("latent")
        if latent is None:
            latent = torch.randn((obs.shape[0], latent_width),
                                 generator=generator, device=obs.device)
        act, _ = det_policy(traj, obs, generator, latent_noise=latent)
        _, extras = stoch_policy(traj, obs, generator, latent_noise=latent,
                                 action_noise=noise.get("action"),
                                 uniform=noise.get("uniform"))
        nstate = self._env.step(state, act)
        rtrunk = nstate.info.get("termination_error",
                                 torch.zeros_like(nstate.reward))
        return nstate, {
            "qpos": nstate.pipeline_state.qpos[0], "rtrunk": rtrunk[0],
            "reward": nstate.reward[0], "action": act[0],
            "log_prob": extras["log_prob"][0],
            "rand_log_prob": extras["rand_log_prob"][0]}

    def _graphed_step(self, policy, generator, noise: Dict):
        """(the StateGraph of the episode's step for the noise kinds given
        and this generator, its static noise), made at first use.  The
        graphs read one policy module of the callback's own, a copy of
        the first one given; each call's weights are copied into it in
        place, so a caller's module is never written."""
        if self._policy is None:
            self._policy = copy.deepcopy(policy)
        else:
            self._policy.load_state_dict(policy.state_dict())
        kinds = tuple(sorted(noise))
        key = (kinds, id(generator))
        if key not in self._graphs:
            device = self._env.sys.device
            static = {k: noise[k][0].to(device).clone() for k in kinds}
            make = make_inference_fn(self._policy)
            step = functools.partial(
                self._step, make(deterministic=True), make(),
                self._policy.latent_width, generator, static)
            name = "_".join(("eval_callback_step",) + kinds)
            self._graphs[key] = (StateGraph(step, name=name,
                                            generators=[generator]),
                                 static, generator)
        graph, static, _ = self._graphs[key]
        return graph, static

    def rollout(self, policy, generator: Optional[torch.Generator] = None,
                noise: Optional[Dict[str, Sequence[torch.Tensor]]] = None,
                stop_at_done: bool = False) -> Dict[str, np.ndarray]:
        """One episode of one env with ``policy`` (an IntentionPolicy).
        ``noise`` may fix the draws: ``start_frame`` (1,) and ``reset``
        (1, nq) for the reset, and per step ``latent`` (1, latent),
        ``action`` (1, nu) and ``uniform`` (1, nu); the rest come from
        ``generator``.  With ``stop_at_done`` the episode ends after the
        step that sets ``done`` (one readback a step), else it runs
        ``episode_length`` steps.  Each step is written into slot t of
        (T, ...) series, which a graph replay cannot alias.  Returns
        those series as numpy, and the episode's ``start_frame`` and
        ``clip_id`` (-1 for a single-clip env) as ints."""
        noise = noise or {}
        per_step = {k: noise[k] for k in ("latent", "action", "uniform")
                    if k in noise}
        state = self._env.reset(1, generator=generator,
                                start_frame=noise.get("start_frame"),
                                noise=noise.get("reset"))
        start_frame = int(state.info.get("cur_frame", torch.zeros(1))[0])
        clip_id = int(state.info.get("clip_id", torch.full((1,), -1))[0])
        if self._cuda_graphs:
            graph, static = self._graphed_step(policy, generator, per_step)
        else:
            make = make_inference_fn(policy)
            eager = functools.partial(
                self._step, make(deterministic=True), make(),
                policy.latent_width, generator)
        out, steps = None, self._episode_length
        for t in range(self._episode_length):
            drawn = {k: v[t] for k, v in per_step.items()}
            if self._cuda_graphs:
                for k, v in drawn.items():
                    static[k].copy_(v)
                state, series = graph(state)
            else:
                state, series = eager(drawn, state)
            if out is None:
                out = {k: v.new_empty((self._episode_length,) + v.shape)
                       for k, v in series.items()}
            for k, v in series.items():
                out[k][t].copy_(v)
            if stop_at_done and bool(state.done[0]):
                steps = t + 1
                break
        return dict({k: v[:steps].cpu().numpy() for k, v in out.items()},
                    start_frame=start_frame, clip_id=clip_id)

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
        if self._generator is None:
            self._generator = torch.Generator(device=device)
        traj = self.rollout(policy, self._generator.manual_seed(self._calls))
        series = self.diagnostics(traj)
        if self._plots:
            try:
                series["diag/plots"] = self._render_plots(traj, num_steps)
            except Exception as e:  # plotting must never kill training
                series["diag/plots_error"] = str(e)
        series["diag/eval_callback_s"] = time.perf_counter() - t0
        if self._logger is not None:
            self._logger.log(series, step=num_steps)

        if self._render and self._calls % self._render_every == 0:
            # skip if the previous eval's render is still running (pile-up
            # guard: rendering must never fall behind training)
            if self._pending_render is None or self._pending_render.done():
                qpos, sf, cid = traj["qpos"], traj["start_frame"], \
                    traj["clip_id"]

                def _job():
                    try:
                        return self._render_overlay(qpos, sf, num_steps, cid)
                    except Exception as e:  # never kill training
                        return f"render-error: {e}"

                self._pending_render = self.in_render_thread(_job)
                series["diag/video"] = os.path.join(
                    self._model_path, f"rollout_{num_steps}.mp4")
                series["diag/video_async"] = True
            else:
                series["diag/video_skipped"] = "previous render in flight"
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

    def render_result(self, timeout: Optional[float] = None
                      ) -> Union[str, None]:
        """Waits for the last render job and returns its result: the path
        written, None (no reference clip), or a ``render-error: ...``
        string; None when no render was started."""
        if self._pending_render is None:
            return None
        return self._pending_render.result(timeout=timeout)

    def _resolve_ref_clip(self, clip_id: int = -1):
        """The reference clip an episode tracked: the single-clip envs keep
        it as ``_ref_traj`` (humanoid, ant) or ``_ref_clip`` (rodent); the
        multi-clip env's clip is the one of ``clip_id`` in its library."""
        env = self._env
        for name in ("_ref_traj", "_ref_clip"):
            ref = getattr(env, name, None)
            if ref is not None:
                return ref
        library = getattr(env, "clip_library", None)
        if library is not None:
            return library.get(max(clip_id, 0))
        return None

    def overlay_inputs(self, qpos_rollout: np.ndarray, start_frame: int,
                       clip_id: int = -1):
        """(agent qpos, reference qpos) of an episode's overlay, (T, nq)
        numpy each, or None without a reference clip."""
        ref = self._resolve_ref_clip(clip_id)
        if ref is None:
            return None
        T = qpos_rollout.shape[0]
        sl = slice(start_frame, start_frame + T)
        qreferences = torch.cat([ref.position[sl], ref.quaternion[sl],
                                 ref.joints[sl]], 1).cpu().numpy()
        n = min(len(qreferences), T)
        return qpos_rollout[:n], qreferences[:n]

    def in_render_thread(self, fn):
        """Runs ``fn()`` on the render worker thread, on its CUDA stream
        where the env has one (waiting for the stream before it returns);
        returns the future."""
        def job():
            if self._render_stream is None:
                return fn()
            with torch.cuda.stream(self._render_stream):
                out = fn()
            self._render_stream.synchronize()
            return out
        return self._render_pool.submit(job)

    def _render_overlay(self, qpos_rollout: np.ndarray, start_frame: int,
                        num_steps: int, clip_id: int = -1) -> Optional[str]:
        from vnl_tpu_torch.render import render_overlay_video
        pair = self.overlay_inputs(qpos_rollout, start_frame, clip_id)
        if pair is None:
            return None
        out = os.path.join(self._model_path, f"rollout_{num_steps}.mp4")
        return render_overlay_video(self._env.sys, *pair, out)
