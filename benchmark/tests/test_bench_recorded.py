"""The readers of the program's spans (benchmark/recorded.py) on a synthetic
Run: each reads its number off ``spans`` and returns None where a run has
none, as from a program without the recorder; the existing readers read
the same with spans as without.  And the recorded run of a small cell on
the CPU: the line keeps benchmark.run's fields, with ``spans`` after
``steps_s``."""

from __future__ import annotations

import json
import time

import pytest

from benchmark import loops, readings, recorded, spec
from benchmark import run as bench_run
from benchmark.tests.conftest import small_cell

SPANS = {
    "steps": [3, 4], "window_s": 2.0, "busy_s": 1.9, "idle_s": 0.1,
    "by_span": {
        "train.step": {"count": 1.0, "host_s": 1.0},
        "rollout.control_step": {"count": 160.0, "host_s": 0.7,
                                 "device_s": 0.72},
        "sgd.update": {"count": 512.0, "host_s": 0.5, "device_s": 0.512,
                       "idle_s": 0.01},
        "train.sgd": {"count": 1.0, "host_s": 0.55, "idle_s": 0.04}},
    "counters": {"graph_nodes": [633408, 633408]},
    "before_s": {"graph.capture": 1.5, "eval": 3.0},
    "clock_error_us": 2.0, "clock_error_after_s": 0.5,
}

WANT = {"train.device_idle_share": 5.0,
        "train.control_step_device_ms": 4.5,
        "train.update_device_ms": 1.0,
        "train.graph_nodes_per_step": 633408.0,
        "setup.capture_s": 1.5}


def _run(**fields) -> loops.Run:
    return loops.Run(setup_parts={"warm_up": 20.0}, window_s=2.0,
                     env_steps=40960, attempted=2, window_steps=2,
                     rollout_s=[0.7, 0.7], sgd_s=[0.6, 0.6],
                     warm_up_s=[1.0, 1.0, 1.0], window_peak_bytes=2 ** 29,
                     **fields)


def _ctx(spans="absent"):
    run = _run()
    if spans != "absent":
        run.spans = spans
    return readings.Context(run=run, cell=spec.cell("twin_train"))


@pytest.mark.parametrize("name,unit", recorded.SPAN_METRICS)
def test_each_reader_reads_the_spans(name, unit):
    assert WANT[name] == pytest.approx(spec.reader(name)(_ctx(SPANS)))
    assert spec.reader(name)(_ctx(None)) is None
    assert spec.reader(name)(_ctx()) is None
    assert spec.NAME_RE.match(name) and spec.UNIT_RE.match(unit)


def test_readers_of_what_the_run_lacks_return_none():
    empty = dict(SPANS, by_span={}, counters={}, before_s={})
    for name, _ in recorded.SPAN_METRICS[1:]:
        assert spec.reader(name)(_ctx(empty)) is None, name
    assert spec.reader("train.device_idle_share")(
        _ctx(dict(SPANS, window_s=0.0))) is None


def test_existing_readers_read_the_same_with_spans():
    cell = spec.cell("twin_train")
    for m in cell.end_to_end + cell.per_layer:
        read = spec.reader(m["name"])
        assert read(_ctx(SPANS)) == read(_ctx()), m["name"]


def test_no_recorder_leaves_spans_none(monkeypatch):
    from vnl_tpu_torch.utils import profiler
    monkeypatch.delattr(profiler, "recording")
    runs = []
    loop = recorded.recorded(lambda *a: _run(), runs)
    run = loop(None, 1, 0.0, False, "cpu", {}, 0.0)
    assert run.spans is None and runs == [run]


def test_the_recorded_line():
    cell = small_cell("twin_train")
    out = recorded.run_cell(cell, 2 ** 31 + 12345, 3.0, False, "cpu",
                            time.perf_counter())
    keys = list(json.loads(recorded.line(out)))
    plain = bench_run.line({k: v for k, v in out.items() if k != "spans"})
    assert [k for k in keys if k != "spans"] == list(json.loads(plain))
    assert keys[keys.index("steps_s") + 1] == "spans"
    spans = out["spans"]
    # the window's steps after its first, which opened at step 1
    assert spans["steps"] == list(range(2, 1 + out["attempted"]))
    assert spans["idle_s"] >= 0
    ppo, by_span = cell.config["ppo"], spans["by_span"]
    unrolls = ppo["batch_size"] * ppo["num_minibatches"] // ppo["num_envs"]
    assert by_span["rollout.control_step"]["count"] == \
        unrolls * ppo["unroll_length"]
    assert by_span["sgd.update"]["count"] == \
        ppo["num_updates_per_batch"] * ppo["num_minibatches"]
    # the CPU runs no graph: no nodes, no captures
    assert {m for m in out["metrics"]} == {
        "setup_s", "train_env_steps_per_s", "train.device_idle_share",
        "train.control_step_device_ms", "train.update_device_ms"}
    assert out["correct"]
