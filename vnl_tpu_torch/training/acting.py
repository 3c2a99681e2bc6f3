"""Rollout collection and periodic evaluation (PyTorch counterpart of
vnl_tpu/training/acting.py): the policy reads the reference-trajectory
features in state.info["traj"] beside the proprioceptive observation.

On a CUDA device the control step can run as one CUDA graph replay
(``ActorStepGraph``), the counterpart of the JAX package's jitted step
inside its scan (acting.py:55), and so does each control step of the
``Evaluator``'s episodes; the CPU runs ``actor_step`` eagerly."""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vnl_tpu_torch.envs.base import State, StateGraph
from vnl_tpu_torch.envs.wrappers import EvalWrapper
from vnl_tpu_torch.training.types import Transition
from vnl_tpu_torch.utils import graphs, profiler


def actor_step(env, env_state: State, policy,
               generator: Optional[torch.Generator] = None,
               extra_fields: Sequence[str] = ()) -> Tuple[State, Transition]:
    """One policy query + one env step."""
    with profiler.part("policy"):
        action, policy_extras = policy(env_state.info["traj"], env_state.obs,
                                       generator)
    with profiler.part("env"):
        next_state = env.step(env_state, action)
        return next_state, Transition(
            observation=env_state.obs, action=action,
            reward=next_state.reward, discount=1.0 - next_state.done,
            next_observation=next_state.obs,
            extras={"policy_extras": policy_extras,
                    "state_extras": {k: next_state.info[k]
                                     for k in extra_fields}})


class ActorStepGraph(StateGraph):
    """``actor_step(env, state, policy, generator, extra_fields)`` as one
    CUDA graph replay a call (envs.base.StateGraph): each call steps the
    static state ``state`` in place and returns it with the step's
    transition, which the next call overwrites."""

    def __init__(self, env, policy, generator: Optional[torch.Generator],
                 extra_fields: Sequence[str] = ()):
        super().__init__(
            functools.partial(actor_step, env, policy=policy,
                              generator=generator,
                              extra_fields=tuple(extra_fields)),
            name="control_step", generators=[generator])


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
                    extra_fields: Sequence[str] = (),
                    step: Optional[ActorStepGraph] = None
                    ) -> Tuple[State, Transition]:
    """``unroll_length`` actor steps; returns the final state and the
    time-leading Transition: each step's transition is written into slot
    t of (T, B, ...) tensors made for this unroll.  ``step``, an
    ActorStepGraph of the same env, policy, generator and extra fields,
    replays the control-step graph in place of ``actor_step``; the final
    state is then its static state, which its next call steps on."""
    if step is None:
        step = functools.partial(actor_step, env, policy=policy,
                                 generator=generator,
                                 extra_fields=tuple(extra_fields))
    state, out = env_state, None
    for t in range(unroll_length):
        with profiler.span("rollout.control_step", device=True):
            state, tr = step(state)
            if out is None:
                out = graphs.map_leaves(
                    lambda x: x.new_empty((unroll_length,) + x.shape), tr)
            graphs.copy_(graphs.map_leaves(lambda x: x[t], out), tr)
    return state, out


class Evaluator:
    """Runs full-episode evaluations on a dedicated wrapped env.

    ``eval_policy`` is the policy function itself: the networks' weights
    live in their module, so it always acts with the current ones (the
    trainer updates them in place, and a graph reads them where they
    live).

    ``cuda_graphs`` (None: on a CUDA device; True on the CPU raises): each
    control step of an episode is one replay of a CUDA graph over the
    ``EvalWrapper`` env at the eval batch (envs.StateGraph), captured at
    the first evaluation and replayed by every later one, the counterpart
    of the JAX package's jitted episodes (vnl_tpu/training/acting.py:79).
    The reset stays eager and is copied into the graph's static state.  An
    evaluation with ``noise["latent"]`` replays a second graph, whose
    policy reads one static latent tensor; step t's draw is copied into it
    before each replay.  ``capture_s`` holds the seconds of the captures
    (``eval/epoch_eval_time`` of the first evaluation includes them)."""

    def __init__(self, eval_env, eval_policy: Callable, num_eval_envs: int,
                 episode_length: int, action_repeat: int,
                 generator: Optional[torch.Generator] = None,
                 cuda_graphs: Optional[bool] = None):
        self._generator = generator
        self._walltime = 0.0
        self.last_state: Optional[State] = None
        self._num_eval_envs = num_eval_envs
        self._episode_steps = episode_length * num_eval_envs
        self._env = EvalWrapper(eval_env)
        self._policy = eval_policy
        self._steps = episode_length // action_repeat
        self._cuda_graphs = graphs.enabled(cuda_graphs, eval_env.sys.device,
                                           "Evaluator")
        # by whether the latent is given: (its StateGraph, static latent)
        self._graphs: Dict[bool, Tuple[StateGraph, Optional[torch.Tensor]]] \
            = {}

    @property
    def graphs(self) -> List[StateGraph]:
        """The episode graphs made so far (one a kind of evaluation)."""
        return [g for g, _ in self._graphs.values()]

    @property
    def capture_s(self) -> float:
        """Seconds of the graphs' captures and instantiations so far."""
        return graphs.capture_s(self.graphs)

    def _step(self, latent: Optional[torch.Tensor], state: State):
        policy = self._policy if latent is None else \
            functools.partial(self._policy, latent_noise=latent)
        next_state, _ = actor_step(self._env, state, policy, self._generator)
        return next_state, None

    def _graph(self, latent: Optional[torch.Tensor]):
        """The StateGraph of an evaluation with or without a given latent,
        and its static latent, made at the first such evaluation."""
        given = latent is not None
        if given not in self._graphs:
            static = latent.to(self._env.sys.device).clone() \
                if given else None
            self._graphs[given] = (StateGraph(
                functools.partial(self._step, static),
                name="eval_step_latent" if given else "eval_step",
                generators=[self._generator]), static)
        return self._graphs[given]

    def _run_episodes(self, noise: Dict) -> State:
        state = self._env.reset(self._num_eval_envs,
                                generator=self._generator,
                                start_frame=noise.get("start_frame"),
                                noise=noise.get("reset"))
        latents = noise.get("latent")
        for t in range(self._steps):
            latent = None if latents is None else latents[t]
            if not self._cuda_graphs:
                state, _ = self._step(latent, state)
                continue
            graph, static = self._graph(latent)
            if static is not None:
                static.copy_(latent)
            state, _ = graph(state)
        return state

    def run_evaluation(self, training_metrics: Dict,
                       aggregate_episodes: bool = True,
                       noise: Optional[Dict] = None) -> Dict:
        """One evaluation.  ``noise`` may fix the draws, as
        EvalCallback.rollout takes them: ``start_frame`` (B,) and
        ``reset`` (B, nq) for the reset, and ``latent`` (B, latent) for
        each step; the rest come from the generator.  Without
        ``aggregate_episodes`` every metric is per episode, and so are the
        lengths, ``eval/episode_length``.  ``last_state`` keeps the final
        state (a graph's static state, which the next evaluation
        overwrites)."""
        with profiler.timed("eval") as span:
            state = self._run_episodes(noise or {})
            self.last_state = state
            tallies = state.info["eval_metrics"]
            names = list(tallies.episode_metrics)
            # one readback: the metric sums and the episode lengths together
            packed = torch.stack([tallies.episode_metrics[n] for n in names]
                                 + [tallies.episode_steps]).cpu().numpy()
        elapsed = span.seconds
        self._walltime += elapsed

        out = {"eval/walltime": self._walltime, **training_metrics}
        for name, per_episode in zip(names, packed):
            if aggregate_episodes:
                out[f"eval/episode_{name}"] = np.mean(per_episode)
                out[f"eval/episode_{name}_std"] = np.std(per_episode)
            else:
                out[f"eval/episode_{name}"] = per_episode
        if not aggregate_episodes:
            out["eval/episode_length"] = packed[-1]
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
