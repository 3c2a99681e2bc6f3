"""Rollout collection (PyTorch counterpart of vnl_tpu/training/acting.py):
the policy reads the reference-trajectory features in state.info["traj"]
beside the proprioceptive observation."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from vnl_tpu_torch.envs.base import State


class Transition(NamedTuple):
    """One env transition; a rollout stacks them time-first."""

    observation: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    discount: torch.Tensor
    next_observation: torch.Tensor
    extras: Dict[str, Any] = {}


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


def _stack(items):
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        return type(first)(*[_stack(list(x)) for x in zip(*items)])
    raise TypeError(f"cannot stack {type(first)}")


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
    return state, _stack(transitions)
