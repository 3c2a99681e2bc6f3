"""A run of the harness with the timed path broken underneath sees
``correct`` come out false: the run drives small cells on the CPU (the
look for a chip skipped) with one fault planted in the program, once for
each fault the cell can have.  A sound run of the same cell is correct.
(One chip: no exchange between chips to leave out.)"""

from __future__ import annotations

import time

import pytest

from benchmark import run as bench_run
from benchmark.tests.conftest import small_cell

SEED = 2 ** 31 + 977


def run_small(name: str, seed: int = SEED, seconds: float = 0.2):
    return bench_run.run_cell(small_cell(name), seed, seconds, False, "cpu",
                              time.perf_counter())


def _unchanged_update(monkeypatch):
    """An update that returns the parameters unchanged."""
    from vnl_tpu_torch.training import gradients
    monkeypatch.setattr(gradients.Adam, "step", lambda self: None)


def _half_batch(monkeypatch):
    """The loss over half of each minibatch's rows, its mean taken over
    the rest."""
    from vnl_tpu_torch.training import losses
    real = losses.compute_ppo_intention_loss

    def half(net, data, *a, **k):
        rows = data.observation.shape[0] // 2
        from benchmark.loops import tree_map_tensors
        return real(net, tree_map_tensors(lambda x: x[:rows], data), *a,
                    **k)
    monkeypatch.setattr(losses, "compute_ppo_intention_loss", half)


def _altered_answer(monkeypatch):
    """One env's position altered where the env step produces it."""
    from vnl_tpu_torch.envs import base
    real = base.PipelineEnv.pipeline_step

    def altered(self, data, ctrl):
        out = real(self, data, ctrl)
        qpos = out.qpos.clone()
        qpos[0, 0] += 1e-2
        return out.replace(qpos=qpos)
    monkeypatch.setattr(base.PipelineEnv, "pipeline_step", altered)


def _unchanged_state(monkeypatch):
    """An env step that returns its physics state unchanged."""
    from vnl_tpu_torch.envs import base
    monkeypatch.setattr(base.PipelineEnv, "pipeline_step",
                        lambda self, data, ctrl: data)


def _altered_step(alter):
    """The rodent env's step with ``alter`` applied to what it returns."""
    def plant(monkeypatch):
        from vnl_tpu_torch.envs import rodent
        real = rodent.RodentTracking.step

        def step(self, state, action):
            return alter(real(self, state, action))
        monkeypatch.setattr(rodent.RodentTracking, "step", step)
    return plant


def _reward(state):
    reward = state.reward.clone()
    reward[0] += 1e-2
    return state.replace(reward=reward)


def _obs(state):
    obs = state.obs.clone()
    obs[0, 0] += 1e-2
    return state.replace(obs=obs)


FAULTS = {"unchanged_update": _unchanged_update,
          "half_batch": _half_batch,
          "altered_answer": _altered_answer,
          "altered_reward": _altered_step(_reward),
          "altered_obs": _altered_step(_obs),
          "unchanged_state": _unchanged_state}


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_sound_run_is_correct(seed):
    out = run_small("twin_train", seed)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_small("twin_train")
    assert not out["correct"], out["checks"]
