"""The control on the card: the reference computed with TF32 products in
the program's place must come out not correct under the cell's limits,
while the program itself comes out correct.  The cell's networks and
envs, one warm-up training step; marked ``cuda`` (TF32 exists only on
the card) and skipped without one."""

from __future__ import annotations

import dataclasses

import pytest

from benchmark import control, judge, spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 products exist only there")
    from vnl_tpu_torch.ops import build
    build.build_all()
    return "cuda"


@pytest.mark.cuda
def test_tf32_control_is_not_correct(card):
    cell = spec.cell("twin_train")
    cell = dataclasses.replace(
        cell, traffic=dict(cell.traffic, warm_up_steps=1))
    limits = cell.config["limits"]["train"]
    row = control.readings(cell, 4200000001, card, True)
    assert judge.verdict(row["program"], limits)[0]
    assert not judge.verdict(row["control"], limits)[0]
    for fault in ("half_batch", "unchanged", "altered_answer",
                  "altered_reward", "altered_obs", "flipped_done"):
        assert not judge.verdict(
            {**row["program"], **row[fault]}, limits)[0]
