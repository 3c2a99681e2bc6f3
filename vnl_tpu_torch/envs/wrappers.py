"""Training wrappers: episode bookkeeping, auto-reset, eval metrics
(PyTorch counterpart of vnl_tpu/envs/wrappers.py).

The port's envs are batched by construction (reset and step act on all B
envs of a State), so the JAX package's VmapWrapper has nothing to do here
and is left out; every per-env scalar of the JAX wrappers is a (B,) tensor.

Deviation mirrored from the JAX package: AutoResetWrapper snapshots and
restores the whole ``info`` dict by default (``restore_info=True``), not
only pipeline_state and obs, so an env's bookkeeping (the rodent's
cur_frame, sub_clip_frame) restarts with the episode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from vnl_tpu_torch.envs.base import State


class Wrapper:
    def __init__(self, env):
        self.env = env

    def reset(self, batch: int, generator=None, **kw) -> State:
        return self.env.reset(batch, generator=generator, **kw)

    def step(self, state: State, action: torch.Tensor) -> State:
        return self.env.step(state, action)

    @property
    def action_size(self) -> int:
        return self.env.action_size

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    def __getattr__(self, name):
        if name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)


class EpisodeWrapper(Wrapper):
    """Maintains the episode step count and the truncation signal."""

    def __init__(self, env, episode_length: int, action_repeat: int = 1):
        super().__init__(env)
        self.episode_length = episode_length
        self.action_repeat = action_repeat

    def reset(self, batch: int, generator=None, **kw) -> State:
        state = self.env.reset(batch, generator=generator, **kw)
        zero = torch.zeros_like(state.done, dtype=torch.float32)
        return state.replace(info=dict(state.info, steps=zero,
                                       truncation=zero))

    def step(self, state: State, action: torch.Tensor) -> State:
        reward = 0.0
        for _ in range(self.action_repeat):
            state = self.env.step(state, action)
            reward = reward + state.reward
        steps = state.info["steps"] + self.action_repeat
        over = steps >= float(self.episode_length)
        done = torch.where(over, torch.ones_like(state.done), state.done)
        truncation = torch.where(over, 1 - state.done,
                                 torch.zeros_like(state.done))
        return state.replace(reward=reward, done=done, info=dict(
            state.info, steps=steps, truncation=truncation))


def _where_done(done: torch.Tensor, x, y):
    """Per env: x where the episode ended, else y; dicts leaf by leaf."""
    if isinstance(x, dict):
        return {k: _where_done(done, v, y[k]) for k, v in x.items()}
    mask = done.bool().reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, x, y)


class AutoResetWrapper(Wrapper):
    """Restores the state captured at reset() when an episode ends (no new
    randomness inside step).

    The snapshot holds only the carried physics state (qpos, qvel, act):
    forward() recomputes every other Data field from those before anything
    reads it.  The observation is restored from the stored first_obs; the
    reward and done of the terminal step are computed before the restore.
    """

    _CARRIED = ("qpos", "qvel", "act")
    _BOOKKEEPING = ("first_pipeline_state", "first_obs", "first_info",
                    "steps", "truncation")

    def __init__(self, env, restore_info: bool = True):
        super().__init__(env)
        self._restore_info = restore_info

    def reset(self, batch: int, generator=None, **kw) -> State:
        state = self.env.reset(batch, generator=generator, **kw)
        ps = state.pipeline_state
        info = dict(state.info)
        info["first_pipeline_state"] = {k: getattr(ps, k)
                                        for k in self._CARRIED}
        info["first_obs"] = state.obs
        if self._restore_info:
            info["first_info"] = {k: v for k, v in state.info.items()
                                  if k not in self._BOOKKEEPING}
        return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        info = dict(state.info)
        if "steps" in info:
            info["steps"] = torch.where(state.done.bool(),
                                        torch.zeros_like(info["steps"]),
                                        info["steps"])
        state = state.replace(done=torch.zeros_like(state.done), info=info)
        state = self.env.step(state, action)
        done = state.done
        ps = state.pipeline_state
        restored = {k: _where_done(done, v, getattr(ps, k))
                    for k, v in state.info["first_pipeline_state"].items()}
        obs = _where_done(done, state.info["first_obs"], state.obs)
        info = dict(state.info)
        if self._restore_info and "first_info" in info:
            for k, v in info["first_info"].items():
                info[k] = _where_done(done, v, info[k])
        return state.replace(pipeline_state=ps.replace(**restored), obs=obs,
                             info=info)


@dataclasses.dataclass(frozen=True, eq=False)
class EvalMetrics:
    episode_metrics: Dict[str, torch.Tensor]
    active_episodes: torch.Tensor
    episode_steps: torch.Tensor


class EvalWrapper(Wrapper):
    """Accumulates per-episode metric sums for the evaluator: each env's
    first episode counts, later ones are masked out."""

    def reset(self, batch: int, generator=None, **kw) -> State:
        state = self.env.reset(batch, generator=generator, **kw)
        metrics = dict(state.metrics, reward=state.reward)
        eval_metrics = EvalMetrics(
            episode_metrics={k: torch.zeros_like(v)
                             for k, v in metrics.items()},
            active_episodes=torch.ones_like(state.reward),
            episode_steps=torch.zeros_like(state.reward))
        return state.replace(metrics=metrics, info=dict(
            state.info, eval_metrics=eval_metrics))

    def step(self, state: State, action: torch.Tensor) -> State:
        tally = state.info["eval_metrics"]
        info = {k: v for k, v in state.info.items() if k != "eval_metrics"}
        nstate = self.env.step(state.replace(info=info), action)
        metrics = dict(nstate.metrics, reward=nstate.reward)
        active = tally.active_episodes
        episode_steps = torch.where(
            active.bool(), nstate.info.get("steps", tally.episode_steps),
            tally.episode_steps)
        eval_metrics = EvalMetrics(
            episode_metrics={k: tally.episode_metrics[k] + v * active
                             for k, v in metrics.items()},
            active_episodes=active * (1 - nstate.done),
            episode_steps=episode_steps)
        return nstate.replace(metrics=metrics, info=dict(
            nstate.info, eval_metrics=eval_metrics))


def wrap_for_training(env, episode_length: int = 1000,
                      action_repeat: int = 1, restore_info: bool = True):
    """EpisodeWrapper -> AutoResetWrapper (the JAX package's order, without
    its VmapWrapper)."""
    env = EpisodeWrapper(env, episode_length, action_repeat)
    return AutoResetWrapper(env, restore_info=restore_info)
