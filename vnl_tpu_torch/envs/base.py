"""Env state and the physics-driven env base (PyTorch counterpart of
vnl_tpu/envs/base.py).  An env here is batched: reset and step act on all
B envs of a State at once."""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from vnl_tpu_torch.physics.forward import forward, make_data, step
from vnl_tpu_torch.physics.model import Data, Model
from vnl_tpu_torch.utils import graphs, profiler


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


def step_in_place(step: Callable, state: State):
    """``step(state) -> (next_state, out)`` with the next state written
    into ``state`` in place (``utils.graphs.copy_``); returns ``out``,
    whose tensors never share storage with ``state``: the body of a
    ``StateGraph``."""
    next_state, out = step(state)
    with profiler.part("env"):
        held = {t.untyped_storage().data_ptr()
                for t in graphs.leaves(state) if t.numel()}
        out = graphs.map_leaves(
            lambda t: t.clone() if t.numel() and
            t.untyped_storage().data_ptr() in held else t, out)
        graphs.copy_(state, next_state)
    return out


class StateGraph:
    """``step(state) -> (next_state, out)`` as one CUDA graph replay a
    call: the counterpart of the JAX package's jitted step inside its
    scan.  Holds the static state (``state``): each call steps it in place
    and returns it with ``out``, whose tensors the next call overwrites.
    A state other than ``state`` is copied into it first, so a reset or a
    restored state reaches the graph.

    The first call runs ``step`` eagerly on a side stream (the warm-up, a
    real step), clones its next state into ``state`` and captures
    ``step_in_place`` on it; ``generators``, those ``step`` draws from,
    are registered with the graph, so the replays draw what eager steps
    would.  CPU states raise."""

    def __init__(self, step: Callable, name: str,
                 generators: Sequence[torch.Generator] = ()):
        self._step, self._name = step, name
        self._generators = [g for g in generators if g is not None]
        self._graph: Optional[graphs.Graph] = None
        self.state: Optional[State] = None

    @property
    def report(self) -> Optional[dict]:
        """The capture's report (utils/graphs.py), once captured."""
        return self._graph.report if self._graph else None

    def __call__(self, state: State):
        if self._graph is None:
            graphs.require_cuda(state, f"the {self._name} graph")
            next_state, out = graphs.warm_up(self._step, state)
            self.state = graphs.clone(next_state)
            self._graph = graphs.Graph(
                functools.partial(step_in_place, self._step),
                (self.state,), name=self._name, generators=self._generators)
            return self.state, out
        if state is not self.state:
            graphs.copy_(self.state, state)
        return self.state, self._graph.replay()


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
