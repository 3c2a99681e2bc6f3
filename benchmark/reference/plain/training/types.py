"""Training container types (PyTorch counterpart of
vnl_tpu/training/types.py)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

Metrics = Dict[str, torch.Tensor]


class Transition(NamedTuple):
    """One env transition with nested extras; a rollout stacks them
    time-first (packed by training/acting.py actor_step)."""

    observation: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    discount: torch.Tensor
    next_observation: torch.Tensor
    extras: Dict[str, Any] = {}
