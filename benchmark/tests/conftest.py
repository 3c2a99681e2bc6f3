"""Small cells for the CPU tests: BENCHMARK.json's cell at a few envs,
narrow networks, two substeps a control step and one warm-up training
step, run by the harness on the CPU (the plain paths)."""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch

from benchmark import spec


def small_cell(name: str) -> spec.Cell:
    cell = spec.cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["ppo"].update(num_envs=4, num_eval_envs=2, episode_length=6,
                      unroll_length=4, batch_size=2, num_minibatches=2,
                      num_updates_per_batch=2)
    cfg["networks"].update(intention_latent_size=8, encoder_layer_sizes=[16],
                           decoder_layer_sizes=[16],
                           value_hidden_layer_sizes=[16])
    cfg["env_args"] = dict(cfg["env_args"], physics_steps_per_control_step=2)
    traffic = dict(cell.traffic, warm_up_steps=1)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


@pytest.fixture(autouse=True)
def few_threads():
    """The test processes share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
