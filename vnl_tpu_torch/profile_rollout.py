"""Where the time of the port's rollout goes, on one CUDA device.

Runs the slice of chip_smoke.py (RodentTracking on the rodent twin,
keeper policy, sampling) at B envs, warms up, then traces a few control
steps with torch.profiler and prints one JSON line: wall time per control
step, device time per kernel group (kernel A, kernel B, the rest), the
number of kernel launches per control step, and the device's busy and
idle shares (sum of kernel times over the wall time of the same work
without the profiler, whose own overhead inflates the wall time; kernels
of one stream do not overlap).

Usage (from the repo root, on the machine with the card):
  python3 -m vnl_tpu_torch.profile_rollout
"""

from __future__ import annotations

import collections
import json
import sys
import time

import torch

BATCH = 1024
STEPS = 4


def device_groups(prof):
    """Device time (us) and launches of a torch.profiler trace by kernel
    group: the hand-written kernels A, B and C, copies, and the rest."""
    groups = collections.Counter()
    launches = collections.Counter()
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name
        key = ("kernel A (position)" if "position_kernel" in name else
               "kernel B (cg)" if "cg_kernel" in name else
               "kernel C (sweep)" if "sweep_kernel" in name else
               "memcpy/memset" if "memcpy" in name.lower()
               or "memset" in name.lower() else "other torch kernels")
        groups[key] += ev.time_range.end - ev.time_range.start   # us
        launches[key] += 1
    return groups, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    from vnl_tpu_torch import compat
    from vnl_tpu_torch.envs import make_twin_env
    from vnl_tpu_torch.models import make_inference_fn
    from vnl_tpu_torch.ops import build
    from vnl_tpu_torch.training import generate_unroll

    build.build_all()
    env = make_twin_env(device="cuda")
    policy = make_inference_fn(compat.policy_from_numpy(
        compat.KEEPER_POLICY, device="cuda"))(deterministic=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = env.reset(BATCH, generator=gen)
    state, _ = generate_unroll(env, state, policy, gen, 2)     # warm-up
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    state, _ = generate_unroll(env, state, policy, gen, STEPS)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = generate_unroll(env, state, policy, gen, STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    groups, launches = device_groups(prof)
    busy_us = sum(groups.values())
    out = dict(
        device=torch.cuda.get_device_name(0), batch=BATCH,
        steps=STEPS,
        env_steps_per_s=BATCH * STEPS / plain_wall,
        wall_ms_per_step=1e3 * plain_wall / STEPS,
        profiled_wall_ms_per_step=1e3 * wall / STEPS,
        device_ms_per_step={k: v / 1e3 / STEPS
                            for k, v in groups.most_common()},
        launches_per_step={k: v / STEPS
                           for k, v in launches.most_common()},
        device_busy_share=busy_us / 1e6 / plain_wall,
        device_idle_share=1.0 - busy_us / 1e6 / plain_wall)
    top = collections.Counter()
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or 0
        if t:
            top[ev.key] += t
    out["top_device_ops_ms_per_step"] = {
        k[:60]: v / 1e3 / STEPS for k, v in top.most_common(8)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
