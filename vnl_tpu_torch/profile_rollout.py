"""Where the time of the port's rollout goes, on one CUDA device.

Runs the slice of chip_smoke.py (RodentTracking on the rodent twin,
keeper policy, sampling) at B envs, warms up, then traces a few control
steps with torch.profiler, eagerly and replayed as a CUDA graph
(training/acting.py ActorStepGraph), and prints one JSON line with both
({"rollout_profile": {"eager": ..., "graphed": ...}}): wall time per
control step, device time per kernel group (kernel A, kernel B, the
rest), the kernels the device runs and the calls by which the host puts
work on it per control step (kernel and graph launches, copies, fills),
and the device's busy and idle shares (sum of kernel times over the wall
time of the same work without the profiler, whose own overhead inflates
the wall time; kernels of one stream do not overlap).  Before that it prints, as one JSON line
{"kernel_stages": ...}, where kernels A, B and C spend their time at B envs
(kernel_bench.stage_split: each kernel whole and with stages left out) and
what each takes of an SM (registers, spill bytes, shared memory, resident
blocks), after the compiler's own resource report.

Usage (from the repo root, on the machine with the card):
  python3 -m vnl_tpu_torch.profile_rollout [--stages-only]
  python3 -m vnl_tpu_torch.profile_rollout --scene humanoid|ant
  python3 -m vnl_tpu_torch.profile_rollout --parts --scene twin|humanoid
(--scene: the stage split of the kernels that scene runs, at its shapes,
and stop; --parts: the eager control step's device time by tagged part,
{"part_profile": ...}, and stop)
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
import time
from typing import Optional

import torch

BATCH = 1024
STEPS = 4


# the hand-written kernels by group, every route of each (csrc/*.cu),
# demangled or not
KERNEL_GROUPS = tuple(
    (group, re.compile(rf"(?<![a-z_]){names}_kernel(?![a-z_])"))
    for group, names in (("kernel A (position)", "position(_warp)?"),
                         ("kernel B (cg)", "cg(_wide)?"),
                         ("kernel C (sweep)", "sweep(_tile|_warp)?"),
                         ("kernel D (constraints)", "constraints"),
                         ("kernel E (collision)", "collision")))


def _group(name: str) -> Optional[str]:
    """The hand-written kernel group of a kernel name, if any."""
    return next((k for k, pattern in KERNEL_GROUPS if pattern.search(name)),
                None)


def _device_events(prof):
    """The device's work in a trace: its events less the device side of
    ``record_function`` ranges."""
    return [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


def device_groups(prof):
    """Device time (us) and launches of a torch.profiler trace by kernel
    group: the hand-written kernels A to E, copies, and the
    rest."""
    groups = collections.Counter()
    launches = collections.Counter()
    for ev in _device_events(prof):
        name = ev.name
        key = _group(name) or (
            "memcpy/memset" if "memcpy" in name.lower()
            or "memset" in name.lower() else "other torch kernels")
        groups[key] += ev.time_range.end - ev.time_range.start   # us
        launches[key] += 1
    return groups, launches


# the host's calls that put work on the device, as the profiler names them
HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                 "cudaMemcpyAsync", "cudaMemsetAsync")


def host_launches(prof) -> int:
    """The calls of ``HOST_LAUNCHES`` in a torch.profiler trace."""
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CPU
               and ev.name.startswith(HOST_LAUNCHES))


def profile_rollout(cuda_graphs: bool, batch: int = BATCH,
                    steps: int = STEPS) -> dict:
    """The twin rollout at ``batch`` envs, keeper policy, sampling: two
    warm-up control steps (with ``cuda_graphs``, the capture), ``steps``
    timed, ``steps`` traced."""
    from vnl_tpu_torch import compat
    from vnl_tpu_torch.envs import make_twin_env
    from vnl_tpu_torch.models import make_inference_fn
    from vnl_tpu_torch.training import ActorStepGraph, generate_unroll

    env = make_twin_env(device="cuda")
    policy = make_inference_fn(compat.policy_from_numpy(
        compat.KEEPER_POLICY, device="cuda"))(deterministic=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = ActorStepGraph(env, policy, gen) if cuda_graphs else None
    state = env.reset(batch, generator=gen)
    state, _ = generate_unroll(env, state, policy, gen, 2, step=step)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    state, _ = generate_unroll(env, state, policy, gen, steps, step=step)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = generate_unroll(env, state, policy, gen, steps,
                                   step=step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    groups, launches = device_groups(prof)
    busy_us = sum(groups.values())
    out = dict(
        device=torch.cuda.get_device_name(0), batch=batch,
        steps=steps, cuda_graphs=cuda_graphs,
        env_steps_per_s=batch * steps / plain_wall,
        wall_ms_per_step=1e3 * plain_wall / steps,
        profiled_wall_ms_per_step=1e3 * wall / steps,
        device_ms_per_step={k: v / 1e3 / steps
                            for k, v in groups.most_common()},
        launches_per_step={k: v / steps
                           for k, v in launches.most_common()},
        host_launches_per_step=host_launches(prof) / steps,
        device_busy_share=busy_us / 1e6 / plain_wall,
        device_idle_share=1.0 - busy_us / 1e6 / plain_wall,
        graph=step.report if step else None)
    top = collections.Counter()
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or 0
        if t:
            top[ev.key] += t
    out["top_device_ops_ms_per_step"] = {
        k[:60]: v / 1e3 / steps for k, v in top.most_common(8)}
    return out


# the part of the control step that launches each hand-written kernel on
# the fused paths: their launches go through ctypes and leave no
# operation in the trace to find a range around
KERNEL_PARTS = {"kernel A (position)": "position", "kernel B (cg)": "solve",
                "kernel D (constraints)": "constraints",
                "kernel E (collision)": "collision"}


def device_by_part(prof):
    """Device time (us) and kernels of a torch.profiler trace by tagged
    part of the control step (utils/profiler.py ``part``): each
    operation's kernels go to the innermost ``part.<name>`` range around
    it, "(untagged)" where there is none, and the hand-written kernels to
    their parts by name (``KERNEL_PARTS``)."""
    times, kernels = collections.Counter(), collections.Counter()
    for ev in _device_events(prof):
        key = KERNEL_PARTS.get(_group(ev.name))
        if key:
            times[key] += ev.time_range.end - ev.time_range.start
            kernels[key] += 1
    for ev in prof.events():
        found = [k for k in ev.kernels if _group(k.name) not in KERNEL_PARTS]
        if not found:
            continue
        tag = ev
        while tag is not None and not tag.name.startswith("part."):
            tag = tag.cpu_parent
        key = tag.name[5:] if tag else "(untagged)"
        times[key] += sum(k.duration for k in found)
        kernels[key] += len(found)
    return times, kernels


def profile_parts(scene: str, batch: int = 128, steps: int = STEPS) -> dict:
    """The eager control step of ``scene`` (twin or humanoid, wrapped for
    training, a fresh intention network at upstream's widths, sampling) at
    ``batch`` envs: two warm-up steps, ``steps`` traced; device time and
    kernels a control step by tagged part, beside the trace's whole
    device time.  A graph replays the same kernels with shorter gaps."""
    from vnl_tpu_torch import models
    from vnl_tpu_torch.envs import (HumanoidTracking, make_twin_env,
                                    wrap_for_training)
    from vnl_tpu_torch.training import generate_unroll

    raw = (make_twin_env(device="cuda") if scene == "twin"
           else HumanoidTracking(device="cuda"))
    env = wrap_for_training(raw, episode_length=150)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = env.reset(batch, generator=gen)
    net = models.make_intention_ppo_networks(
        state.info["traj"].shape[-1], state.obs.shape[-1], env.action_size,
        encoder_layer_sizes=(256, 128), decoder_layer_sizes=(128, 256),
        generator=torch.Generator().manual_seed(1),
        device="cuda")
    policy = models.make_inference_fn(net)(deterministic=False)
    extra = ("truncation", "traj")
    state, _ = generate_unroll(env, state, policy, gen, 2, extra)
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = generate_unroll(env, state, policy, gen, steps, extra)
        torch.cuda.synchronize()
    by_part, launches = device_by_part(prof)
    groups, _ = device_groups(prof)
    return dict(scene=scene, batch=batch, steps=steps,
                device_ms_per_step={k: v / 1e3 / steps
                                    for k, v in by_part.most_common()},
                kernels_per_step={k: v / steps
                                  for k, v in launches.most_common()},
                tagged_ms_per_step=sum(by_part.values()) / 1e3 / steps,
                trace_device_ms_per_step=sum(groups.values()) / 1e3 / steps)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    p = argparse.ArgumentParser()
    p.add_argument("--stages-only", action="store_true",
                   help="print the kernels' stage split and stop")
    p.add_argument("--scene", default="twin",
                   choices=("twin", "humanoid", "ant"),
                   help="humanoid, ant: only the stage split of the kernels "
                        "that scene runs (A and B; A)")
    p.add_argument("--parts", action="store_true",
                   help="print the eager control step's device time by "
                        "tagged part for --scene (twin or humanoid) at "
                        "the benchmark cells' 128 envs, and stop")
    args = p.parse_args()
    if args.parts and args.scene == "ant":
        p.error("--parts profiles the twin or the humanoid")

    from vnl_tpu_torch import compat, kernel_bench
    from vnl_tpu_torch.bench import gpu_name_and_power_limit
    from vnl_tpu_torch.ops import build
    from vnl_tpu_torch.physics import forward

    build.build_all()
    if args.parts:
        forward.pin_fp32()
        print(json.dumps({"part_profile": dict(
            profile_parts(args.scene),
            card=gpu_name_and_power_limit())}))
        return 0
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[nvcc {name}] {line.strip()}")
    forward.pin_fp32()
    if args.scene == "twin":
        stages = kernel_bench.stage_split(
            compat.model_from_numpy(compat.TWIN_MODEL, device="cuda"), BATCH)
    else:
        m, kw = kernel_bench.scene(args.scene)
        stages = kernel_bench.stage_split(m, BATCH, **kw)
    print(json.dumps({"kernel_stages": dict(
        stages, scene=args.scene, card=gpu_name_and_power_limit())}),
        flush=True)
    if args.stages_only or args.scene != "twin":
        return 0

    print(json.dumps({"rollout_profile": {
        "eager": profile_rollout(False), "graphed": profile_rollout(True),
        "card": gpu_name_and_power_limit()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
