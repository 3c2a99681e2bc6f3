"""The check that no run loads JAX or the JAX package, and that the
benchmark's sources import neither (nor the reference the port)."""

from __future__ import annotations

import ast
import os

from benchmark import imports, spec

BENCH = os.path.join(spec.ROOT, "benchmark")


def test_forbidden_names_by_whole_top_level_name():
    loaded = ["os", "torch", "vnl_tpu_torch", "vnl_tpu_torch.envs.rodent",
              "jaxtyping", "flaxen", "vnl_tpu_torchx"]
    assert imports.forbidden(loaded) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "vnl_tpu",
           "vnl_tpu.envs"]
    assert imports.forbidden(loaded + bad) == sorted(bad)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        assert imports.forbidden(_imported(path)) == [], path


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        names = [n.split(".")[0] for n in _imported(path)]
        assert "vnl_tpu_torch" not in names, path


def test_without_a_card_the_command_prints_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from benchmark import run
    rc = run.main(["--workload", "twin_train", "--seed", "3000000000",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
