"""The trainer's spans (vnl_tpu_torch/utils/profiler.py) on the CPU: (a) an
eager training step of the twin runs no operation outside a device span
but operations on metadata alone; (b) under torch.profiler every recorded
span lies within 1 ms of its ``record_function`` range, on one clock; (c)
the idle arithmetic on synthetic spans; (d) with no recording open a
training step keeps no event, no fine span and no range, and logs the
``training/*`` keys it logged before the spans.  PhaseTimer's parity with
the JAX package is tests/test_torch_profiler.py."""

import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vnl_tpu_torch import models
from vnl_tpu_torch.envs import make_twin_env
from vnl_tpu_torch.training import train
from vnl_tpu_torch.utils import profiler

TINY = dict(episode_length=6, num_envs=4, num_eval_envs=2, unroll_length=4,
            batch_size=2, num_minibatches=2, num_updates_per_batch=2,
            normalize_observations=True, learning_rate=1e-3, seed=3,
            num_evals=1)
STEP = 2 * 4 * 2                 # env steps a training step

DEVICE_SPANS = {"rollout.control_step", "rollout.concat", "train.normalizer",
                "sgd.shuffle", "sgd.update", "sgd.flush", "train.stats"}
TIMED = {"train.step", "train.rollout", "train.sgd", "eval"}

# operations that touch no element: views and aliases, allocation, detach
METADATA = {"aten::empty", "aten::empty_strided", "aten::new_empty",
            "aten::detach", "aten::alias", "aten::lift_fresh"}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _train(steps, progress_fn=lambda *a: None):
    def factory(*args, **kw):
        return models.make_intention_ppo_networks(
            *args, intention_latent_size=8, encoder_layer_sizes=(16,),
            decoder_layer_sizes=(16,), value_hidden_layer_sizes=(16,), **kw)

    env = make_twin_env(device="cpu", fused_position=False,
                        physics_steps_per_control_step=2)
    return train(env, num_timesteps=steps * STEP, network_factory=factory,
                 device="cpu", progress_fn=progress_fn, **TINY)


class _Ops(TorchDispatchMode):
    """Each operation dispatched, with the host time it ran at."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append((func, time.time_ns()))
        return func(*args, **(kwargs or {}))


def _inside(t, spans):
    return any(s.start_ns <= t <= s.end_ns for s in spans)


def test_device_spans_cover_every_operation_of_a_step():
    with profiler.recording("cpu") as rec, _Ops() as ops:
        _train(1)
    (step,) = [s for s in rec.spans if s.name == "train.step"]
    device = [s for s in rec.spans if s.name in DEVICE_SPANS]
    assert {s.name for s in device} == DEVICE_SPANS
    in_step = [(f, t) for f, t in ops.seen
               if step.start_ns <= t <= step.end_ns]
    outside = {f._schema.name for f, t in in_step
               if not (f.is_view or f._schema.name in METADATA
                       or _inside(t, device))}
    assert not outside, sorted(outside)
    assert len(in_step) > 1000
    # every device span is a child of its step's phases
    for s in device:
        assert rec.spans[s.parent].name in (
            "train.rollout", "train.sgd", "train.step"), s.name


def test_span_clock_is_the_profilers():
    with profiler.recording("cpu") as rec, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):   # its first call
            pass                                          # is slow
        _train(1)
    names = {s.name for s in rec.spans}
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in names:
            ranges.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    by_name = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s)
    assert set(by_name) == DEVICE_SPANS | TIMED
    for name, spans in by_name.items():
        got = sorted(ranges[name])
        assert len(got) == len(spans), name
        for s, (start, end) in zip(spans, got):
            assert abs(s.start_ns - start) < 1e6, name
            assert abs(s.end_ns - end) < 1e6, name


def _span(name, start, end, device=None, step=0):
    s = profiler.Span(None, name, step=step)
    s.start_ns, s.end_ns = start, end
    if device is not None:
        s.device_start_ns, s.device_end_ns = device
    return s


def test_idle_arithmetic_on_synthetic_spans():
    spans = [
        _span("train.step", 0, 1000),
        _span("train.rollout", 0, 600),
        _span("rollout.control_step", 15, 100, device=(20, 300)),
        _span("rollout.control_step", 110, 200, device=(250, 400)),
        _span("train.sgd", 620, 990),
        _span("sgd.update", 630, 700, device=(640, 900)),
        # a step after the window's, and a span before it
        _span("train.step", 1100, 2000, step=1),
        _span("graph.capture", -50, -10, step=-1),
    ]
    busy = profiler.busy_intervals(spans, 0, 1000)
    assert busy == [(20, 400), (640, 900)]          # overlaps count once
    gaps = profiler.idle_gaps(busy, 0, 1000)
    assert gaps == [(0, 20), (400, 640), (900, 1000)]
    # middles 10 and 520 lie in train.rollout, 950 in train.sgd: the
    # innermost spans there, not train.step around them
    assert profiler.gap_owners(spans, gaps) == [
        "train.rollout", "train.rollout", "train.sgd"]
    assert profiler.gap_owners(spans, [(30, 50), (1000, 1100)]) == [
        "rollout.control_step", "(no span)"]

    rec = profiler.Recording()
    rec.spans = spans
    rec.counters["graph_nodes"].update({0: 7, 1: 9})
    out = rec.summary([0])
    approx = pytest.approx
    assert out["steps"] == [0] and out["window_s"] == approx(1e-6)
    assert out["busy_s"] == approx(640e-9)
    assert out["idle_s"] == approx(360e-9)
    row = out["by_span"]["rollout.control_step"]
    assert row["count"] == 2 and row["device_s"] == approx(430e-9)
    assert row["host_s"] == approx(175e-9) and "idle_s" not in row
    assert out["by_span"]["train.rollout"]["idle_s"] == approx(260e-9)
    assert out["longest_gaps"] == [["train.rollout", approx(240e-9)],
                                   ["train.sgd", approx(100e-9)],
                                   ["train.rollout", approx(20e-9)]]
    assert "device_s" not in out["by_span"]["train.sgd"]
    assert out["counters"] == {"graph_nodes": [7]}
    assert out["before_s"] == {"graph.capture": approx(40e-9)}
    assert rec.summary([5]) is None
    two = rec.summary([0, 1])
    assert two["window_s"] == approx(2e-6)
    assert two["counters"] == {"graph_nodes": [7, 9]}
    assert two["by_span"]["train.step"]["count"] == 1


def test_counters_and_steps_of_a_recording():
    with profiler.recording() as rec:
        profiler.count("graph_nodes", 3)
        for n in range(2):
            with profiler.timed("train.step", step=n):
                with profiler.span("sgd.update", device=True) as s:
                    profiler.count("graph_nodes", 5)
                    profiler.count("graph_nodes", 5)
                assert s.step == n and s.device_start_ns == s.start_ns
    assert dict(rec.counters["graph_nodes"]) == {-1: 3, 0: 10, 1: 10}
    assert [s.step for s in rec.spans] == [0, 0, 1, 1]
    with pytest.raises(RuntimeError):
        with profiler.recording(), profiler.recording():
            pass


def test_nothing_is_kept_with_recording_off(monkeypatch):
    made = []

    class Counted(profiler.Span):
        __slots__ = ()

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self.name)

    def refuse(*args, **kw):
        raise AssertionError("recorded with recording off")

    monkeypatch.setattr(profiler, "Span", Counted)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    logged = []
    _train(2, progress_fn=lambda step, m: logged.append(m))
    assert set(made) == TIMED
    assert made.count("train.step") == 2
    assert profiler.span("sgd.update", device=True) is profiler.NULL
    assert profiler.span("train.stats") is profiler.NULL
    training = {k for k in logged[-1] if k.startswith("training/")}
    assert training == {"training/sps", "training/walltime",
                        "training/rollout_s_per_step",
                        "training/sgd_s_per_step"} | {
        f"training/{n}" for n in (
            "total_loss", "policy_loss", "v_loss", "entropy_loss",
            "kl_loss_intention", "prediction_corr", "explained_variance")}
    assert 0 < logged[-1]["training/rollout_s_per_step"]
    assert 0 < logged[-1]["training/sgd_s_per_step"]
