"""A cell run as ``benchmark.run`` runs it, with the program's span recorder
(``vnl_tpu_torch.utils.profiler.recording``) open around the loop, from
before train() to after the window.  Prints the same result line with a
``spans`` field after ``steps_s`` (the recorder's summary of the window's
training steps: per span name, count, host, device-busy and idle seconds a
step; ``Recording.summary``) and, among its metrics, those read off the
spans:

  train.device_idle_share       % of the window's wall time (from its
                                second step's start to its last one's end)
                                outside every device span
  train.control_step_device_ms  mean device ms of a rollout.control_step
                                (the control-step graph's replay and copy)
  train.update_device_ms        mean device ms of an sgd.update (copy in,
                                the SGD-update graph's replay, copy out)
  train.graph_nodes_per_step    graph nodes replayed a window step
  setup.capture_s               seconds of graph.capture spans ended
                                before the window

  python3 -m benchmark.recorded --workload <name> --seed <n> \\
      --seconds <s> --trace <0|1>

Their readers (``metrics/<name>.py``) return None for a run without spans,
as from a program without the recorder.  ``benchmark.run`` opens no
recording, so BENCHMARK.json lists none of them yet; ``recorded`` gives the
run its ``spans`` from outside, where a Run field and ``loops.run_train``
would."""

from __future__ import annotations

import json
import statistics
import sys
from typing import Callable, Dict, List, Optional

from benchmark import run as bench_run
from benchmark import loops, readings, spec

# the metrics read off the spans: (name, unit)
SPAN_METRICS = (("train.device_idle_share", "%"),
                ("train.control_step_device_ms", "ms"),
                ("train.update_device_ms", "ms"),
                ("train.graph_nodes_per_step", "nodes"),
                ("setup.capture_s", "s"))

_run_cell, _line = bench_run.run_cell, bench_run.line


def recorded(loop: Callable, runs: List[loops.Run]) -> Callable:
    """``loop`` with the program's recorder open around it; the Run it
    hands back (also appended to ``runs``) gains ``spans``, the summary of
    the window's training steps after its first, by the ids the harness
    counts them by (None where the program has no recorder).  The first
    is left out: at its start, inside its ``train.rollout`` span, the
    harness does its own work (it reads the launch probe; a traced run
    stops the profiler, tens of seconds), which is no device span's and
    would read as the device's idle time."""

    def run_recorded(cell, seed, seconds, traced, device, parts, t0):
        try:
            from vnl_tpu_torch.utils.profiler import recording
        except ImportError:
            run = loop(cell, seed, seconds, traced, device, parts, t0)
            run.spans = None
        else:
            with recording(device) as rec:
                run = loop(cell, seed, seconds, traced, device, parts, t0)
            opened = len(run.warm_up_s)
            run.spans = rec.summary(range(opened + 1,
                                          opened + run.window_steps))
        runs.append(run)
        return run

    return run_recorded


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t0: float) -> Dict:
    """``benchmark.run.run_cell`` under the recorder: its result with the
    span metrics the run gave and ``spans``."""
    runs: List[loops.Run] = []
    with loops.patched(loops, "LOOPS", {k: recorded(v, runs) for k, v
                                        in loops.LOOPS.items()}):
        out = _run_cell(cell, seed, seconds, traced, device, t0)
    ctx = readings.Context(run=runs[-1], cell=cell)
    for name, unit in SPAN_METRICS:
        value = spec.reader(name)(ctx)
        if value is not None:
            out["metrics"][name] = {"value": value, "unit": unit}
    out["spans"] = runs[-1].spans
    return out


def line(result: Dict) -> str:
    """``benchmark.run.line`` with ``spans`` after ``steps_s``."""
    out = {}
    for k, v in json.loads(_line(result)).items():
        out[k] = v
        if k == "steps_s" and "spans" in result:
            out["spans"] = result["spans"]
    return json.dumps(out)


def spans_of(ctx: readings.Context) -> Optional[Dict]:
    return getattr(ctx.run, "spans", None)


def device_idle_share(ctx: readings.Context) -> Optional[float]:
    """Percent of the window's wall time outside every device span."""
    sp = spans_of(ctx)
    if sp is None or sp["window_s"] <= 0:
        return None
    return 100.0 * sp["idle_s"] / sp["window_s"]


def mean_device_ms(ctx: readings.Context, name: str) -> Optional[float]:
    """Mean device milliseconds of a span ``name`` in the window."""
    sp = spans_of(ctx)
    row = None if sp is None else sp["by_span"].get(name)
    if not row or not row["count"] or "device_s" not in row:
        return None
    return 1e3 * row["device_s"] / row["count"]


def graph_nodes_per_step(ctx: readings.Context) -> Optional[float]:
    sp = spans_of(ctx)
    nodes = None if sp is None else sp["counters"].get("graph_nodes")
    return statistics.fmean(nodes) if nodes else None


def capture_s(ctx: readings.Context) -> Optional[float]:
    sp = spans_of(ctx)
    return None if sp is None else sp["before_s"].get("graph.capture")


def main(argv: Optional[List[str]] = None) -> int:
    with loops.patched(bench_run, "run_cell", run_cell), \
            loops.patched(bench_run, "line", line):
        return bench_run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
