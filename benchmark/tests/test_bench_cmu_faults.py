"""``correct`` on the CMU humanoid's cell, ``cmu_train``, against its own
limits: a sound run is correct, and each planted fault that the limits
are set to catch comes out not correct.  On the CPU the harness drives
the small cell (conftest.py) with one fault planted in the program; on
the card the TF32 control and the faults planted in the reference
(benchmark/control.py) go through the judge at the cell's own size.

On the card one env's observation entry moved by 1e-2 (``altered_obs``)
read 134-252 on three seeds against the limit 100: caught there, but
with too little room to hold it to in the card test (PERF.md section 2);
the small cell on the CPU catches it."""

from __future__ import annotations

import dataclasses
import time

import pytest

from benchmark import control, judge, spec
from benchmark import run as bench_run
from benchmark.tests.conftest import small_cell

CELL = "cmu_train"
SEED = 2 ** 31 + 1025


def run_small(seed: int = SEED, seconds: float = 0.2):
    return bench_run.run_cell(small_cell(CELL), seed, seconds, False, "cpu",
                              time.perf_counter())


def _unchanged_update(monkeypatch):
    """An update that returns the parameters unchanged."""
    from vnl_tpu_torch.training import gradients
    monkeypatch.setattr(gradients.Adam, "step", lambda self: None)


def _half_batch(monkeypatch):
    """The loss over half of each minibatch's rows."""
    from benchmark.loops import tree_map_tensors
    from vnl_tpu_torch.training import losses
    real = losses.compute_ppo_intention_loss

    def half(net, data, *a, **k):
        rows = data.observation.shape[0] // 2
        return real(net, tree_map_tensors(lambda x: x[:rows], data), *a,
                    **k)
    monkeypatch.setattr(losses, "compute_ppo_intention_loss", half)


def _altered_qpos(monkeypatch):
    """One env's position altered where the env step produces it."""
    from vnl_tpu_torch.envs import base
    real = base.PipelineEnv.pipeline_step

    def altered(self, data, ctrl):
        out = real(self, data, ctrl)
        qpos = out.qpos.clone()
        qpos[0, 0] += 1e-2
        return out.replace(qpos=qpos)
    monkeypatch.setattr(base.PipelineEnv, "pipeline_step", altered)


def _altered_obs(monkeypatch):
    """One env's first observation entry moved by 1e-2 where the CMU
    humanoid's step makes it."""
    from vnl_tpu_torch.envs import humanoid
    real = humanoid.HumanoidTracking.step

    def step(self, state, action):
        out = real(self, state, action)
        obs = out.obs.clone()
        obs[0, 0] += 1e-2
        return out.replace(obs=obs)
    monkeypatch.setattr(humanoid.HumanoidTracking, "step", step)


def _unchanged_state(monkeypatch):
    """An env step that returns its physics state unchanged."""
    from vnl_tpu_torch.envs import base
    monkeypatch.setattr(base.PipelineEnv, "pipeline_step",
                        lambda self, data, ctrl: data)


def _altered_reward(monkeypatch):
    """One env's reward moved by 1e-2 where the CMU humanoid's step (the
    humanoid env's) makes it."""
    from vnl_tpu_torch.envs import humanoid
    real = humanoid.HumanoidTracking.step

    def step(self, state, action):
        out = real(self, state, action)
        reward = out.reward.clone()
        reward[0] += 1e-2
        return out.replace(reward=reward)
    monkeypatch.setattr(humanoid.HumanoidTracking, "step", step)


FAULTS = {"unchanged_update": _unchanged_update,
          "half_batch": _half_batch,
          "altered_answer": _altered_qpos,
          "altered_reward": _altered_reward,
          "altered_obs": _altered_obs,
          "unchanged_state": _unchanged_state}


def test_sound_run_is_correct():
    out = run_small()
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_small()
    assert not out["correct"], out["checks"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 products exist only there")
    from vnl_tpu_torch.ops import build
    build.build_all()
    return "cuda"


@pytest.mark.cuda
def test_tf32_control_and_faults_are_not_correct(card):
    """The cell at its own size, one warm-up training step: the program
    is correct; the TF32 control, half of each minibatch, one env's qpos,
    its reward and its ``done`` are not."""
    cell = spec.cell(CELL)
    cell = dataclasses.replace(
        cell, traffic=dict(cell.traffic, warm_up_steps=1))
    limits = cell.config["limits"]["train"]
    row = control.readings(cell, 2500000201, card, True)
    assert judge.verdict(row["program"], limits)[0]
    assert not judge.verdict(row["control"], limits)[0]
    for fault in ("half_batch", "unchanged", "altered_answer",
                  "altered_reward", "flipped_done"):
        assert not judge.verdict(
            {**row["program"], **row[fault]}, limits)[0], fault
