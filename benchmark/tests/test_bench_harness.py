"""The harness: cells, configurations, mixes and metric readers found by
name; new files picked up without an edit; BENCHMARK.json within the
contract's rules; the result line's keys."""

from __future__ import annotations

import json
import os
import shutil
import time

import pytest

from benchmark import loops, run as bench_run, spec
from benchmark.tests.conftest import small_cell

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_by_name(name):
    cell = spec.cell(name)
    assert cell.traffic["loop"] in loops.LOOPS
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    for path in (cell.config["program"]["env"],
                 cell.config["reference"]["env"]):
        assert callable(loops.resolve(path))
    assert set(cell.config["limits"]) >= {cell.traffic["loop"]}


def test_names_and_units_use_the_allowed_characters():
    assert spec.problems(BENCH) == []
    bad = json.loads(json.dumps(BENCH))
    bad["per_layer"][0]["name"] = "has space"
    bad["per_layer"][1]["unit"] = "tokens per s"
    bad["workloads"][0]["traffic"] = "a/b"
    assert len(spec.problems(bad)) == 3


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("benchmark/") for f in files)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert m["moves"] in {e["name"]
                                  for e in spec.cell(w).end_to_end}
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_new_configuration_mix_and_metric_are_picked_up(tmp_path):
    root = tmp_path
    for d in ("configs", "traffic", "metrics"):
        os.makedirs(root / "benchmark" / d)
    shutil.copy(os.path.join(spec.ROOT, "benchmark", "configs",
                             "rodent_twin.json"),
                root / "benchmark" / "configs" / "other.json")
    (root / "benchmark" / "traffic" / "new_mix.json").write_text(
        json.dumps({"loop": "train", "warm_up_steps": 3}))
    (root / "benchmark" / "metrics" / "new.metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench = {
        "configs": [{"name": "other", "file": "benchmark/configs/other.json",
                     "source": "x", "reduced": [], "why": "x"}],
        "workloads": [{"name": "cell", "config": "other",
                       "traffic": "new_mix", "chips": 1, "why": "x"}],
        "end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower",
                        "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": "new.metric", "unit": "%", "better": "higher",
                       "source": "device_trace", "layer": "x",
                       "moves": "setup_s"}]}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("cell", root=str(root))
    assert cell.traffic["warm_up_steps"] == 3
    assert cell.config["sizes"]["obs_size"] == 232
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    assert spec.reader("new.metric", root=str(root))(None) == 42.0


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(traced):
    cell = small_cell("twin_train")
    out = bench_run.run_cell(cell, 12345, 0.0, traced, "cpu",
                             time.perf_counter())
    keys = list(json.loads(bench_run.line(out)))
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in keys) == traced
    assert set(out["checks"]) == set(cell.config["limits"]["train"])
    names = {m["name"] for m in (cell.per_layer if traced
                                 else cell.end_to_end)}
    assert set(out["metrics"]) <= names
    if not traced:
        assert set(out["metrics"]) == names
    assert out["attempted"] > 0 and out["failed"] == 0


def test_the_launch_probe_reads_nothing_on_the_cpu():
    from benchmark import device
    probe = device.LaunchProbe("cpu")
    assert probe.us_per_node() is None
    assert probe.fast()
