"""The readings that the limits of ``correct`` are set from, in one
process on the chip (the benchmark's own runs never run this):

- the program's readings on each seed (sound runs: the lower reading);
- the control: the reference put in the program's place and computed in
  the nearest precision below the configuration's float32, TF32 in its
  matrix products, against the float32 reference (the upper reading);
- the faults, planted in the reference put in the program's place: one
  env's answer altered where the step produces it (its position, its
  reward or an entry of its observation by 1e-2, or its ``done``
  flipped), and half of each minibatch left out (the loss's mean over the
  rest); a state left unchanged reads 1 on the change after three
  updates by the judge's measure, and needs no run.

Each seed runs the cell's own set-up and traffic with a window of one
training step.

  python3 -m benchmark.control --workload <name> --seeds 11,12,13 \\
      [--control-seeds 11,12,13] [--out FILE]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Dict, List, Optional


def _altered_qpos(post) -> None:
    post.pipeline_state.qpos[0, 0] += 1e-2


def _altered_reward(post) -> None:
    post.reward[0] += 1e-2


def _altered_obs(post) -> None:
    post.obs[0, 0] += 1e-2


def _flipped_done(post) -> None:
    post.done[0] = 1 - post.done[0]


def readings(cell, seed: int, device, control: bool) -> Dict:
    """One seed: the program's readings and, with ``control``, the
    control's and the faults'."""
    import torch

    from benchmark import judge, loops

    loop = cell.traffic["loop"]
    run = loops.LOOPS[loop](cell, seed, 0.0, False, device, {},
                            time.perf_counter())
    inputs = run.judge_inputs
    del run
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    cfg = cell.config
    out = {"seed": seed, "program": judge.numbers(cfg, loop, inputs, device)}
    if not control:
        return out
    pre, action = inputs["pre"], inputs["action"]
    fp32 = judge.reference_step(cfg, pre, action, device)
    exact = judge.reference_step(cfg, pre, action, device,
                                 dtype=torch.float64)
    moved = [judge.reference_step(
        cfg, judge.nudged(judge.to_reference(pre, torch.float64), sign),
        action, device, dtype=torch.float64) for sign in (1.0, -1.0)]
    tf32 = judge.reference_step(cfg, pre, action, device, tf32=True)
    out["control"] = judge.env_numbers(tf32, fp32, exact, moved)
    # one env's answer altered where it is produced: its position, its
    # reward, an entry of its observation; its done flipped
    for fault, alter in (("altered_answer", _altered_qpos),
                         ("altered_reward", _altered_reward),
                         ("altered_obs", _altered_obs),
                         ("flipped_done", _flipped_done)):
        altered = loops.clone_tree(inputs["post"])
        alter(altered)
        out[fault] = judge.env_numbers(altered, fp32, exact, moved)
    if loop == "train":
        ref = judge.reference_updates(cfg, inputs, device)
        low = judge.reference_updates(cfg, inputs, device, tf32=True)
        out["control"].update(judge.sgd_numbers(
            low, ref, inputs["init_weights"], ref["grad1"]))
        half = judge.reference_updates(cfg, inputs, device, half_batch=True)
        out["half_batch"] = judge.sgd_numbers(
            half, ref, inputs["init_weights"], ref["grad1"])
        out["unchanged"] = {"change3": 1.0}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    from benchmark import spec
    os.environ["VNL_TPU_TORCH_BUILD"] = os.path.join(spec.ROOT, "build",
                                                     "kernels")
    import torch
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    from vnl_tpu_torch.ops import build
    build.build_all()
    torch.set_num_threads(2)
    cell = spec.cell(args.workload)
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    seeds = [int(x) for x in args.seeds.split(",")]
    rows = []
    for s in seeds:
        rows.append(readings(cell, s, "cuda", s in controls))
        print(json.dumps({"control_row": rows[-1]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows,
                       "card": torch.cuda.get_device_name(0)}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
