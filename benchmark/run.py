"""Runs one cell of BENCHMARK.json on the machine it is started on and
prints one JSON line: ``correct``, ``attempted``, ``failed``, the cell's
metrics (its end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device``, with ``--trace 1`` a ``breakdown``, and last the
numbers compared beside their limits (``checks``), which also end
standard error.

  python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, and when JAX or the JAX package was loaded.  The kernels'
libraries are built into ``build/kernels`` of the checkout
(``VNL_TPU_TORCH_BUILD``), so only the first run of a checkout compiles.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()        # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from benchmark import imports, spec  # noqa: E402


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t0: float) -> Dict:
    """Set-up, window and judgement of one cell on ``device``; the result
    line's fields.  The look for a chip is the caller's."""
    import torch

    from benchmark import judge, loops, readings

    parts = {"imports": time.perf_counter() - t0}
    if torch.device(device).type == "cuda":
        from vnl_tpu_torch.ops import build
        build.build_all()
    parts["kernels_loaded"] = time.perf_counter() - t0
    loop = cell.traffic["loop"]
    run = loops.LOOPS[loop](cell, seed, seconds, traced, device, parts, t0)
    ctx = readings.Context(run=run, cell=cell)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    out = {"attempted": run.attempted, "failed": 0, "metrics": metrics,
           "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.busy_s
        dev["window_s"] = run.traced_window_s
        out["breakdown"] = {"device_ops": run.trace.top_device_ops(10),
                            "idle_gaps": run.trace.idle_gaps(10)}
    out["setup_parts"] = dict(parts)
    # seconds of each training step: the warm-up's, and the window's
    # rollouts and SGD
    out["steps_s"] = {"warm_up": run.warm_up_s, "rollout": run.rollout_s,
                      "sgd": run.sgd_s}
    # the card's launch speed (device.py) at the window's open and close
    out["us_per_node"] = [run.us_per_node_open, run.us_per_node_close]

    # the judge runs once the program's state is gone
    inputs = run.judge_inputs
    run.judge_inputs = {}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    readings_ = judge.numbers(cell.config, loop, inputs, device)
    out["judge_s"] = time.perf_counter() - t
    correct, checks = judge.verdict(readings_,
                                    cell.config["limits"][loop])
    out["readings"] = readings_
    out["correct"] = correct
    out["checks"] = checks
    return out


def line(result: Dict) -> str:
    """The result as the one JSON line: the driver's keys first, the
    checks last."""
    keys = ["correct", "attempted", "failed", "metrics", "device",
            "breakdown", "setup_parts", "steps_s", "us_per_node", "judge_s",
            "readings", "checks"]
    return json.dumps({k: result[k] for k in keys if k in result})


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    os.environ["VNL_TPU_TORCH_BUILD"] = os.path.join(spec.ROOT, "build",
                                                     "kernels")
    import torch
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0)
    found = imports.forbidden(sys.modules)
    if found:
        print(f"benchmark: loaded JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    for k, v in result["setup_parts"].items():
        print(f"setup {k} {v:.3f} s", file=sys.stderr)
    for k, v in result["readings"].items():
        print(f"reading {k} {v!r}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
