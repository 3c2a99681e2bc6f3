"""Env state and the physics-driven env base (PyTorch counterpart of
vnl_tpu/envs/base.py).  An env here is batched: reset and step act on all
B envs of a State at once."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from vnl_tpu_torch.physics.forward import forward, make_data, step
from vnl_tpu_torch.physics.model import Data, Model


@dataclasses.dataclass(frozen=True, eq=False)
class State:
    pipeline_state: Data
    obs: torch.Tensor          # (B, obs)
    reward: torch.Tensor       # (B,)
    done: torch.Tensor         # (B,)
    metrics: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kwargs) -> "State":
        return dataclasses.replace(self, **kwargs)


class PipelineEnv:
    """Env driven by the physics engine with ``n_frames`` substeps per
    control step.

    ``fused_position`` chooses the position stage of every substep: kernel
    A (the default), or the unfused stage on kernel C.  It is the
    counterpart of the JAX package's pallas_position.enabled()."""

    def __init__(self, model: Model, n_frames: int = 1,
                 fused_position: bool = True):
        self._model = model
        self._n_frames = n_frames
        self._fused_position = fused_position

    @property
    def sys(self) -> Model:
        return self._model

    @property
    def dt(self) -> float:
        return self._model.opt.timestep * self._n_frames

    @property
    def n_frames(self) -> int:
        return self._n_frames

    @property
    def fused_position(self) -> bool:
        return self._fused_position

    @property
    def action_size(self) -> int:
        return self._model.nu

    def pipeline_init(self, qpos: torch.Tensor, qvel: torch.Tensor,
                      act: torch.Tensor = None) -> Data:
        d = make_data(self._model, qpos.shape[0], qpos=qpos, qvel=qvel)
        if act is not None:
            d = d.replace(act=act)
        return forward(self._model, d, fused_position=self._fused_position)

    def pipeline_step(self, data: Data, ctrl: torch.Tensor) -> Data:
        """n_frames substeps.  The first inverts the mass matrix exactly;
        with the fused stage so do the others, while the unfused stage
        refines the carried inverses on them (as the JAX package does when
        its fused position kernel is off, envs/base.py:114-125)."""
        fused = self._fused_position
        data = step(self._model, data.replace(ctrl=ctrl),
                    fused_position=fused)
        for _ in range(self._n_frames - 1):
            data = step(self._model, data, refine_inverse=not fused,
                        fused_position=fused)
        return data
