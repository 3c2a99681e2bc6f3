"""vnl_tpu_torch.run_humanoid, the port's humanoid learning run, against
the JAX package's tools/run_humanoid_tpu.py and tools/run_humanoid_cpu.py.

- The ``train(...)`` arguments of both presets (``cuda``: the TPU tool's,
  ``cpu``: the CPU tool's) equal the tools' literals, read from their
  source with ``ast`` (nothing of vnl_tpu is imported), at the tools'
  default step and env counts and at others;
- with ``training.train`` replaced by a stub that calls ``progress_fn``
  three times, the command line on the CPU writes one JSONL row an
  evaluation and the curve PNG under ``--out``, and prints the tools'
  per-evaluation lines and their "first eval reward -> best" line."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from vnl_tpu_torch import run_humanoid, training

import torch_parity as tp


def tool_train_call(name, num_timesteps=None, num_envs=None):
    """The keyword arguments of ``training.train(...)`` in
    tools/<name>.py, evaluated with the tool's NUM_TIMESTEPS and NUM_ENVS
    (their defaults unless given), progress_fn left out."""
    with open(os.path.join(tp.ROOT, "tools", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    names = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.IfExp) \
                and node.targets[0].id in ("NUM_TIMESTEPS", "NUM_ENVS"):
            names[node.targets[0].id] = ast.literal_eval(node.value.orelse)
    defaults = dict(names)
    if num_timesteps is not None:
        names["NUM_TIMESTEPS"] = num_timesteps
    if num_envs is not None:
        names["NUM_ENVS"] = num_envs
    (call,) = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and isinstance(n.func, ast.Attribute) and n.func.attr == "train"
               and getattr(n.func.value, "id", None) == "training"]
    return defaults, {
        kw.arg: eval(compile(ast.Expression(kw.value), name, "eval"),
                     {}, dict(names))
        for kw in call.keywords if kw.arg != "progress_fn"}


@pytest.mark.parametrize("device,tool", [("cuda", "run_humanoid_tpu"),
                                         ("cpu", "run_humanoid_cpu")])
@pytest.mark.parametrize("counts", [None, (40960, 64)])
def test_presets_equal_the_tools_literals(device, tool, counts):
    steps, envs = counts or (None, None)
    defaults, want = tool_train_call(tool, steps, envs)
    assert tuple(defaults[k] for k in ("NUM_TIMESTEPS", "NUM_ENVS")) == \
        run_humanoid.DEFAULTS[device]
    assert run_humanoid.train_kwargs(device, steps, envs) == want


def test_the_command_line_writes_its_rows_and_curve(tmp_path, monkeypatch,
                                                    capsys):
    seen = {}

    def train(env, progress_fn, device, **kw):
        seen.update(kw, device=device, env=env)
        for step, reward in ((0, 0.25), (20480, 1.5), (40960, 1.0)):
            progress_fn(step, {"eval/episode_reward": np.float32(reward),
                               "eval/avg_episode_length": 10.0 + step / 4096,
                               "training/sps": 1000.0, "note": "text"})
        return None, (None, {}), {}

    monkeypatch.setattr(training, "train", train)
    out = tmp_path / "out"
    rec = run_humanoid.main(["40960", "64", "--device", "cpu", "--out",
                             str(out)])
    assert seen["device"] == "cpu" and seen["num_envs"] == 64
    assert seen["num_timesteps"] == 40960 and seen["batch_size"] == 2
    assert type(seen["env"]).__name__ == "HumanoidTracking"
    with open(out / "metrics_humanoid.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [0, 20480, 40960]
    assert rows[1] == {"step": 20480, "eval/episode_reward": 1.5,
                       "eval/avg_episode_length": 15.0,
                       "training/sps": 1000.0}
    with open(out / "curve_humanoid.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    printed = capsys.readouterr().out.splitlines()
    assert "[     20480] reward=1.5000 len=15.0" in printed
    assert "first eval reward 0.2500 -> best 1.5000" in printed
    last = json.loads(printed[-1])["run_humanoid"]
    assert last["curve"] == [[0, 0.25, 10.0], [20480, 1.5, 15.0],
                             [40960, 1.0, 20.0]]
    assert (rec["first_reward"], rec["best_reward"], rec["last_reward"]) \
        == (0.25, 1.5, 1.0)
    assert not os.path.exists(os.path.join(tp.ROOT, "logs",
                                           "metrics_humanoid.jsonl"))
