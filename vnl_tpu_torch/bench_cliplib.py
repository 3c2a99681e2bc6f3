"""Clip-library scaling probe of the port on one CUDA device (the
counterpart of tools/bench_cliplib.py).

Measures the env-steps/s of ``rodent_multiclip`` as the library grows
(2, 8 and 64 clips by default).  Each env gathers its clip from one
stacked library tensor by its clip id, so the rate should stay flat in
the library's size; a drop would mean the gather copies clips per env.

The library follows the tool's rule (tools/bench_cliplib.py:44-55) on the
env config's recording (by default the rodent twin's 250 frames,
vnl_tpu_torch/configs/rodent_twin_config.yaml): clips of
``max(25, T // max(2, min(n, 10)))`` frames cut by
``data.process_recording``, tiled to at least n clips and cut to n, with
``sub_clip_length = min(config's, clip_length - 6)``.  The traffic is the
tool's: the env wrapped for training with episodes of 100 steps
(auto-reset on), actions uniform in [-1, 1], a sample of a reset and 40
control steps, the best of 3 samples after a warm-up.  Each control step,
its action draw included, is one replay of a CUDA graph
(``envs.StateGraph``); the reset stays eager and counts in the sample,
as it counts in the tool's program.

  python -m vnl_tpu_torch.bench_cliplib [num_envs] [sizes]

prints the tool's line for each size (clips, clip length, library MB,
env-steps/s, the capture's seconds), then one JSON line,
{"cliplib": ...}, with the card's name and power limit.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vnl_tpu_torch.ops import build, launch_counts
from vnl_tpu_torch.physics.forward import pin_fp32
from vnl_tpu_torch.train import CONFIGS

TWIN_CONFIG = os.path.join(CONFIGS, "rodent_twin_config.yaml")
NUM_ENVS = 1024
SIZES = (2, 8, 64)
STEPS = 40              # control steps a sample
SAMPLES = 3
EPISODE_LENGTH = 100


def recording(cfg: Dict, device="cuda") -> np.ndarray:
    """The config's clip as one (T, nq) qpos recording."""
    from vnl_tpu_torch.data import load_clip
    clip = load_clip(cfg["env"]["clip_path"], device=device)
    return torch.cat([clip.position, clip.quaternion, clip.joints],
                     1).cpu().numpy()


def library(model, qpos: np.ndarray, n_clips: int):
    """The tool's library of ``n_clips`` clips cut from ``qpos``."""
    from vnl_tpu_torch.data import ClipLibrary, process_recording
    base_len = max(25, qpos.shape[0] // max(2, min(n_clips, 10)))
    lib = process_recording(model, qpos, clip_length=base_len)
    reps = int(np.ceil(n_clips / lib.num_clips))

    def tile(x):
        return x.repeat((reps,) + (1,) * (x.ndim - 1))[:n_clips]

    clips = dataclasses.replace(lib.clips, **{
        f.name: tile(getattr(lib.clips, f.name))
        for f in dataclasses.fields(lib.clips)
        if getattr(lib.clips, f.name) is not None})
    return ClipLibrary(clips=clips, weights=tile(lib.weights))


def library_mb(lib) -> float:
    return sum(getattr(lib.clips, f.name).nbytes
               for f in dataclasses.fields(lib.clips)
               if getattr(lib.clips, f.name) is not None) / 1e6


def env_args(cfg: Dict, lib, device) -> Dict:
    """The config's env args for a library: its clip length, and the
    sub-clip length cut to fit it (the tool's rule)."""
    args = dict(cfg["env"]["env_args"], device=device)
    args.update(clip_length=lib.clip_length,
                sub_clip_length=min(int(args["sub_clip_length"]),
                                    lib.clip_length - 6))
    return args


def run(num_envs: int = NUM_ENVS, sizes: Sequence[int] = SIZES,
        device="cuda", steps: int = STEPS, samples: int = SAMPLES,
        warmup: int = 1, cfg: Optional[Dict] = None) -> List[Dict]:
    """The probe: one row a library size with the tool's numbers and the
    final state of the last sample (``state``); every sample resets from
    a generator seeded with 0 (the tool's PRNGKey(0)).  On a CUDA device
    each control step is a replay of a CUDA graph; the CPU steps eagerly
    (the tests, at a few envs)."""
    from vnl_tpu_torch.envs import StateGraph, wrap_for_training
    from vnl_tpu_torch.envs.rodent import (RodentMultiClipTracking,
                                           _split_compile_args,
                                           compile_rodent)
    from vnl_tpu_torch.utils import graphs, load_config
    cfg = cfg if cfg is not None else load_config(TWIN_CONFIG)
    compile_kw, _ = _split_compile_args(dict(cfg["env"]["env_args"],
                                             device=device))
    model = compile_rodent(**compile_kw)
    qpos = recording(cfg, device)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rows = []
    for n_clips in sizes:
        lib = library(model, qpos, n_clips)
        _, kwargs = _split_compile_args(env_args(cfg, lib, device))
        env = wrap_for_training(RodentMultiClipTracking(model, lib, **kwargs),
                                episode_length=EPISODE_LENGTH)
        gen = torch.Generator(device=device)

        def draw_and_step(state):
            a = 2.0 * torch.rand(num_envs, env.action_size, generator=gen,
                                 device=device) - 1.0
            return env.step(state, a), None

        step = StateGraph(draw_and_step, f"cliplib_step_{n_clips}", [gen]) \
            if cuda else draw_and_step

        def sample():
            state = env.reset(num_envs, generator=gen.manual_seed(0))
            for _ in range(steps):
                state, _ = step(state)
            return state

        seconds, launches = [], []
        for _ in range(1 + warmup + samples):
            before = dict(launch_counts)
            sync()
            t0 = time.perf_counter()
            state = sample()
            sync()
            seconds.append(time.perf_counter() - t0)
            launches.append({k: launch_counts.get(k, 0) - before.get(k, 0)
                             for k in ("position", "cg", "sweep")})
        best = min(seconds[1 + warmup:])
        report = step.report if cuda else None
        capture_s = graphs.capture_s([step]) if cuda else 0.0
        row = dict(clips=lib.num_clips, clip_length=lib.clip_length,
                   library_mb=library_mb(lib),
                   env_steps_per_s=num_envs * steps / best,
                   sample_s=seconds[1 + warmup:], first_sample_s=seconds[0],
                   capture_s=capture_s, graph=report,
                   launches_per_sample=launches[-1],
                   clip_ids=torch.bincount(state.info["clip_id"],
                                           minlength=lib.num_clips).tolist(),
                   state=state)
        rows.append(row)
        print(f"clips={row['clips']:4d} clip_len={row['clip_length']:4d} "
              f"lib={row['library_mb']:7.1f} MB  rollout "
              f"{row['env_steps_per_s'] / 1e3:6.1f}k sps  "
              f"[capture {capture_s:.2f}s]", flush=True)
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("vnl_tpu_torch.bench_cliplib: no CUDA device", file=sys.stderr)
        return 1
    num_envs = int(argv[0]) if argv else NUM_ENVS
    sizes = ([int(s) for s in argv[1].split(",")] if len(argv) > 1
             else list(SIZES))
    from vnl_tpu_torch.bench import gpu_name_and_power_limit
    build.build_all()
    pin_fp32()
    rows = run(num_envs, sizes)
    rates = [r["env_steps_per_s"] for r in rows]
    print(json.dumps({"cliplib": {
        "envs": num_envs, "steps_per_sample": STEPS,
        "rows": [{k: v for k, v in r.items() if k != "state"}
                 for r in rows],
        "flatness": min(rates) / max(rates),
        "name_and_power_limit": gpu_name_and_power_limit()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
