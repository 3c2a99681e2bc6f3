#!/usr/bin/env python3
"""Drives the PyTorch port (vnl_tpu_torch) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero:
  1. build the hand-written CUDA kernels (csrc/*.cu, nvcc for sm_90a);
  2. kernel A (position stage) against its plain PyTorch version on 1024
     rodent-twin states with random joint angles;
  3. kernel B (CG contact solve) against its plain version on 1024 contact
     states made by kernel A, the port's collision and its constraints;
  4. the slice: RodentTracking (twin + clip) reset for 1024 envs and a
     20-control-step generate_unroll (100 physics substeps) with the keeper
     policy, sampling from a seeded generator; A and B must each launch at
     least 100 times in it, and every qpos, qvel and reward must be finite;
  5. kernel C (SPD sweep inverse) against its plain version on the
     (2048, 73, 73) stack [qM, qM + h diag(B)] of 1024 twin states and on a
     (12, 29, 29) batch, with torch.linalg.inv timed beside it;
  6. training at full width: train(...) with the arguments of
     vnl_tpu_torch/bench.py (1024 envs, networks (1024, 1024), a shortened
     episode) for four training steps with the fused position stage
     (kernel A) and two with the unfused one (kernel C), an evaluation
     after every interval; losses must be finite, parameters must move,
     and the launch counts must be those of the chosen stage.
Then it prints the training env-steps/s of both configurations, the card's
name and power limit, one JSON line with each kernel's launches, time per
launch, plain time, bound and error, and last {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--out details.json]
(needs one CUDA device; builds into build/kernels).  Imports nothing of
JAX or vnl_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 1024
UNROLL = 20
SEED = 0
EVAL_EPISODE = 30     # control steps per episode in phase 6 (bench: 150)
# published H100 SXM peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def random_states(m, batch, gen):
    """Root near its rest pose with a random tilt, hinges uniform inside
    their ranges."""
    dev = m.device
    qpos = m.qpos0.expand(batch, -1).clone()
    qpos[:, :3] += 0.01 * torch.randn(batch, 3, generator=gen, device=dev)
    quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev) + 0.2 * torch.randn(
        batch, 4, generator=gen, device=dev)
    qpos[:, 3:7] = quat / quat.norm(dim=-1, keepdim=True)
    lo, hi = m.jnt_range[1:, 0], m.jnt_range[1:, 1]
    u = torch.rand(batch, m.nq - 7, generator=gen, device=dev)
    qpos[:, 7:] = lo + u * (hi - lo)
    return qpos.contiguous()


def check_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: max |err| {float(err.max()):.3e} beyond rtol {rtol} "
            f"atol {atol:.3e} at {int(bad.sum())} entries")
    return float(err.max())


def phase_kernel_a(m, gen):
    from vnl_tpu_torch.ops import position as pos
    from vnl_tpu_torch.physics import inertia
    qpos = random_states(m, BATCH, gen)
    ker = pos._launch(m, qpos)
    plain = pos.position_plain(m, qpos)
    torch.cuda.synchronize()
    errs = {}
    nplain = len(pos.OUTPUT_NAMES) - 2
    for name, k, p in zip(pos.OUTPUT_NAMES[:nplain], ker, plain):
        errs[name] = check_close(name, k, p, 2e-5, 2e-5)
    qM = ker[11]
    eye = torch.eye(m.nv, device=qpos.device)
    hB = torch.diag(m.opt.timestep * m.dof_damping)
    for name, k, p, A in zip(("qMinv", "qMhBinv"), ker[12:], plain[12:],
                             (qM, qM + hB)):
        scale = float(p.abs().max())
        errs[name] = check_close(name, k, p, 5e-3, 1e-4 * scale)
        resid = float((A @ k - eye).abs().max())
        if not resid < 5e-3:
            raise AssertionError(f"{name}: |A X - I| = {resid:.3e}")
        errs[name + "_resid"] = resid
    ms = time_ms(lambda: pos._launch(m, qpos))
    plain_ms = time_ms(lambda: pos.position_plain(m, qpos), reps=5)
    nmat = 2 if inertia.needs_implicit_damping(m) else 1
    out_floats = sum(int(np.prod(s)) for s in pos.output_shapes(m))
    nbytes = BATCH * 4 * (m.nq + out_floats)
    flops = BATCH * 2 * nmat * m.nv ** 3    # the sweeps; the rest is < 5%
    b_ms, b_by = bound_ms(nbytes, flops)
    return dict(name="position", route="cuda",
                source="vnl_tpu_torch/csrc/position.cu",
                replaces="vnl_tpu/ops/pallas_position.py:229",
                max_abs_err=max(v for k, v in errs.items()
                                if not k.endswith("_resid")),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None), errs


def contact_states(m, gen):
    """Kernel-A states pressed into the floor, through collision and
    constraints, up to the CG solve's inputs."""
    from vnl_tpu_torch.physics import actuation, forward, inertia, solver
    qpos = random_states(m, BATCH, gen)
    qpos[:, 2] -= 0.005
    qvel = 0.5 * torch.randn(BATCH, m.nv, generator=gen, device=m.device)
    d = forward.make_data(m, BATCH, qpos=qpos, qvel=qvel)
    d, efc = forward.fwd_position(m, d)
    d = forward.fwd_velocity(m, d)
    _, qfrc_act, _ = actuation.actuation(m, d)
    qacc_smooth = inertia.solve_m(d, d.qfrc_passive - d.qfrc_bias + qfrc_act)
    active = int((d.contact_dist < 0).sum())
    return solver.cg_inputs(m, d, efc, qacc_smooth,
                            max(m.opt.iterations, 1)), active


def cg_cost(st, args):
    """(bytes, flops) of one CG solve of the batch."""
    nv, nc, nl = st.nv, st.ncon, st.nlimit
    nbytes = sum(a.numel() for a in args) * 4 + BATCH * (2 * nv + 4 * nc) * 4
    chain = float(st.chain1.sum() + st.chain2.sum())
    jx = 2 * 6 * chain + nc * 3 * 12 * 2 + nl
    jtf = nc * 2 * 6 * 3 * 2 + 2 * 6 * chain + nv * 12 + nl
    ls = st.ls_iters * (nl + 4 * nc) * 6
    per_iter = 2 * 2 * nv * nv + jx + jtf + ls + 10 * nv
    flops = BATCH * (st.iters * per_iter + jx + jtf + 2 * nv * nv)
    return nbytes, flops


def phase_kernel_b(m, gen):
    from vnl_tpu_torch.ops import cg as cg_ops
    (args, st), active = contact_states(m, gen)
    ker = cg_ops._launch(st, args)
    plain = cg_ops.cg_plain(*args, statics=st)
    torch.cuda.synchronize()
    errs = {n: check_close(n, k, p, 1e-3, 1e-3)
            for n, k, p in zip(("qacc", "qfrc_constraint", "con_f"), ker,
                               plain)}
    ms = time_ms(lambda: cg_ops._launch(st, args))
    plain_ms = time_ms(lambda: cg_ops.cg_plain(*args, statics=st), reps=5)
    b_ms, b_by = bound_ms(*cg_cost(st, args))
    return dict(name="cg", route="cuda", source="vnl_tpu_torch/csrc/cg.cu",
                replaces="vnl_tpu/ops/pallas_cg.py:74",
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None), \
        dict(errs, active_contacts=active, ncon=st.ncon, nlimit=st.nlimit)


def phase_rollout(device):
    from vnl_tpu_torch import compat
    from vnl_tpu_torch.envs import make_twin_env
    from vnl_tpu_torch.models import make_inference_fn
    from vnl_tpu_torch.ops import launch_counts, reset_launch_counts
    from vnl_tpu_torch.training import generate_unroll
    env = make_twin_env(device=device)
    policy_net = compat.policy_from_numpy(compat.KEEPER_POLICY, device=device)
    policy = make_inference_fn(policy_net)(deterministic=False)
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = env.reset(BATCH, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, rollout = generate_unroll(env, state, policy, gen, UNROLL)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = dict(launch_counts)
    d = state.pipeline_state
    finite = all(bool(torch.isfinite(x).all())
                 for x in (d.qpos, d.qvel, rollout.reward,
                           rollout.observation))
    if not finite:
        raise AssertionError("non-finite qpos, qvel, reward or obs")
    if rollout.reward.shape != (UNROLL, BATCH) or \
            state.obs.shape != (BATCH, 232) or \
            state.info["traj"].shape != (BATCH, 795):
        raise AssertionError("unexpected rollout shapes")
    need = UNROLL * env.n_frames
    for k in ("position", "cg"):
        if counts.get(k, 0) < need:
            raise AssertionError(f"kernel {k} launched {counts.get(k, 0)} "
                                 f"times in the rollout, expected >= {need}")
    return counts, dict(
        reset_s=t1 - t0, unroll_s=t2 - t1,
        env_steps_per_s=BATCH * UNROLL / (t2 - t1),
        mean_reward=float(rollout.reward.mean()),
        done_share=float(rollout.discount.eq(0).float().mean()),
        root_z_mean=float(d.qpos[:, 2].mean()))


def spd_batch(batch, n, gen):
    """Random SPD matrices with uneven row scales (the inputs of the JAX
    package's sweep test)."""
    scale = 0.05 + 1.95 * torch.rand(batch, 1, n, generator=gen,
                                     device="cuda")
    L = torch.randn(batch, n, n, generator=gen, device="cuda") * scale
    a = L @ L.transpose(1, 2) + 0.5 * torch.eye(n, device="cuda")
    return (0.5 * (a + a.transpose(1, 2))).contiguous()


def phase_kernel_c(m, gen):
    from vnl_tpu_torch.ops import position as pos
    from vnl_tpu_torch.ops import sweep
    qM = pos._launch(m, random_states(m, BATCH, gen))[11]
    hB = torch.diag(m.opt.timestep * m.dof_damping)
    pair = torch.stack([qM, qM + hB])               # (2, B, nv, nv)
    errs = {}
    for name, a in (("twin_pair", pair), ("spd_12x29", spd_batch(12, 29,
                                                                 gen))):
        ker = sweep._launch(a)
        plain = sweep.inv_spd_sweep_plain(a)
        torch.cuda.synchronize()
        scale = float(plain.abs().max())
        errs[name] = check_close(name, ker, plain, 5e-3, 1e-4 * scale)
        resid = float((a @ ker - torch.eye(a.shape[-1], device="cuda")
                       ).abs().max())
        if not resid < 5e-3:
            raise AssertionError(f"{name}: |A X - I| = {resid:.3e}")
        errs[name + "_resid"] = resid
        errs[name + "_asym"] = float((ker - ker.transpose(-1, -2)
                                      ).abs().max())
    ms = time_ms(lambda: sweep._launch(pair))
    plain_ms = time_ms(lambda: sweep.inv_spd_sweep_plain(pair), reps=5)
    flat = pair.reshape(-1, m.nv, m.nv)
    library_ms = time_ms(lambda: torch.linalg.inv(flat), reps=10)
    nmat = flat.shape[0]
    b_ms, b_by = bound_ms(2 * nmat * m.nv ** 2 * 4, nmat * 2 * m.nv ** 3)
    return dict(name="sweep", route="cuda",
                source="vnl_tpu_torch/csrc/sweep.cu",
                replaces="vnl_tpu/ops/pallas_linalg.py:49",
                max_abs_err=errs["twin_pair"], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms), errs


def phase_training(fused: bool, steps: int):
    """train(...) at the bench's widths; returns (launch counts, report)."""
    from vnl_tpu_torch import bench, models
    from vnl_tpu_torch.ops import launch_counts, reset_launch_counts
    made = {}

    def factory(*a, **kw):
        net = models.make_intention_ppo_networks(*a, **kw)
        made["net"] = net
        made["init"] = {k: v.clone() for k, v in net.state_dict().items()}
        return net

    torch.cuda.synchronize()
    reset_launch_counts()
    rep = bench.run(fused, steps, episode_length=EVAL_EPISODE,
                    network_factory=factory)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    bad = [k for k, v in rep["metrics"].items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite training metrics: {bad}")
    now = made["net"].state_dict()
    still = [k for k, v in made["init"].items()
             if k.endswith("weight") and torch.equal(v, now[k])]
    if still:
        raise AssertionError(f"parameters did not move: {still}")
    widths = (made["net"].policy.encoder.proj_0.out_features,
              made["net"].value.hidden_0.out_features)
    if widths != (1024, 1024):
        raise AssertionError(f"networks are not full width: {widths}")
    nsteps = 2 * steps                       # warm-up + measured interval
    a, b, c = (counts.get(k, 0) for k in ("position", "cg", "sweep"))
    ok = (b >= 100 * nsteps and
          ((a >= 100 * nsteps and c == 0) if fused
           else (a == 0 and c >= 20 * nsteps)))
    if not ok:
        raise AssertionError(
            f"fused={fused}: launches A {a}, B {b}, C {c} over {nsteps} "
            "training steps do not match the chosen position stage")
    print(json.dumps({"training": {k: v for k, v in rep.items()
                                   if k != "metrics"}}), flush=True)
    return counts, rep


def main() -> int:
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script drives "
                    "the port on a CUDA device")
    sys.path.insert(0, ROOT)
    from vnl_tpu_torch import compat
    from vnl_tpu_torch.ops import build
    from vnl_tpu_torch.physics import forward

    p = argparse.ArgumentParser()
    p.add_argument("--out", default="",
                   help="also write the details as JSON to this file")
    args = p.parse_args()
    device = "cuda"
    forward.pin_fp32()
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}

    t = t_start = time.perf_counter()
    build.build_all()
    info["build_s"] = time.perf_counter() - t
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[nvcc {name}] {line.strip()}")

    m = compat.model_from_numpy(compat.TWIN_MODEL, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    row_a, errs_a = phase_kernel_a(m, gen)
    row_b, errs_b = phase_kernel_b(m, gen)
    counts, info["rollout"] = phase_rollout(device)
    row_c, errs_c = phase_kernel_c(m, gen)
    counts_fused, info["training_fused"] = phase_training(True, steps=2)
    counts_unfused, info["training_unfused"] = phase_training(False, steps=1)
    kernels = [row_a, row_b, row_c]
    for row in kernels:
        # summed over the paths, each counted from zero on its own
        row["launches"] = sum(c.get(row["name"], 0) for c in
                              (counts, counts_fused, counts_unfused))
        if row["launches"] < 1:
            raise AssertionError(f"kernel {row['name']} never launched on "
                                 "the main paths")
    info["details"] = {"position": errs_a, "cg": errs_b, "sweep": errs_c}

    from vnl_tpu_torch.bench import gpu_name_and_power_limit
    smi = gpu_name_and_power_limit()
    info["total_s"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(info, kernels=kernels, smi=smi), f, indent=1)
    print(json.dumps(info))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
