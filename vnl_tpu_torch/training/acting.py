"""Rollout collection and periodic evaluation (PyTorch counterpart of
vnl_tpu/training/acting.py): the policy reads the reference-trajectory
features in state.info["traj"] beside the proprioceptive observation."""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vnl_tpu_torch.envs.base import State
from vnl_tpu_torch.envs.wrappers import EvalWrapper
from vnl_tpu_torch.training.types import Transition


def actor_step(env, env_state: State, policy,
               generator: Optional[torch.Generator] = None,
               extra_fields: Sequence[str] = ()) -> Tuple[State, Transition]:
    """One policy query + one env step."""
    action, policy_extras = policy(env_state.info["traj"], env_state.obs,
                                   generator)
    next_state = env.step(env_state, action)
    return next_state, Transition(
        observation=env_state.obs, action=action, reward=next_state.reward,
        discount=1.0 - next_state.done, next_observation=next_state.obs,
        extras={"policy_extras": policy_extras,
                "state_extras": {k: next_state.info[k]
                                 for k in extra_fields}})


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensors of equally shaped nests of dicts and
    (named) tuples."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return type(first)(*[tree_map(fn, *xs) for xs in zip(*trees)])
    raise TypeError(f"cannot map over {type(first)}")


def generate_unroll(env, env_state: State, policy,
                    generator: Optional[torch.Generator],
                    unroll_length: int,
                    extra_fields: Sequence[str] = ()
                    ) -> Tuple[State, Transition]:
    """``unroll_length`` actor steps; returns the final state and the
    stacked (time-leading) Transition."""
    transitions = []
    state = env_state
    for _ in range(unroll_length):
        state, tr = actor_step(env, state, policy, generator, extra_fields)
        transitions.append(tr)
    return state, tree_map(lambda *xs: torch.stack(xs), *transitions)


class Evaluator:
    """Runs full-episode evaluations on a dedicated wrapped env.

    ``eval_policy`` is the policy function itself: the networks' weights
    live in their module, so it always acts with the current ones."""

    def __init__(self, eval_env, eval_policy: Callable, num_eval_envs: int,
                 episode_length: int, action_repeat: int,
                 generator: Optional[torch.Generator] = None):
        self._generator = generator
        self._walltime = 0.0
        self._num_eval_envs = num_eval_envs
        self._episode_steps = episode_length * num_eval_envs
        self._env = EvalWrapper(eval_env)
        self._policy = eval_policy
        self._steps = episode_length // action_repeat

    def _run_episodes(self) -> State:
        state = self._env.reset(self._num_eval_envs,
                                generator=self._generator)
        for _ in range(self._steps):
            state, _ = actor_step(self._env, state, self._policy,
                                  self._generator)
        return state

    def run_evaluation(self, training_metrics: Dict,
                       aggregate_episodes: bool = True) -> Dict:
        start = time.time()
        state = self._run_episodes()
        tallies = state.info["eval_metrics"]
        names = list(tallies.episode_metrics)
        # one readback: the metric sums and the episode lengths together
        packed = torch.stack([tallies.episode_metrics[n] for n in names]
                             + [tallies.episode_steps]).cpu().numpy()
        elapsed = time.time() - start
        self._walltime += elapsed

        out = {"eval/walltime": self._walltime, **training_metrics}
        for name, per_episode in zip(names, packed):
            if aggregate_episodes:
                out[f"eval/episode_{name}"] = np.mean(per_episode)
                out[f"eval/episode_{name}_std"] = np.std(per_episode)
            else:
                out[f"eval/episode_{name}"] = per_episode
        out["eval/avg_episode_length"] = float(np.mean(packed[-1]))
        # multi-clip envs: per-clip episode reward (clip_id is stable per
        # episode: the AutoReset info snapshot restores it)
        clip_ids = state.info.get("clip_id")
        if clip_ids is not None and aggregate_episodes:
            ids = clip_ids.cpu().numpy()
            rew = packed[names.index("reward")]
            for cid in np.unique(ids):
                out[f"eval/episode_reward_clip{int(cid)}"] = float(
                    np.mean(rew[ids == cid]))
        out["eval/epoch_eval_time"] = elapsed
        out["eval/sps"] = self._episode_steps / elapsed
        return out
