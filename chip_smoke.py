#!/usr/bin/env python3
"""Drives the PyTorch port (vnl_tpu_torch) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero:
  1. build the hand-written CUDA kernels (csrc/*.cu, nvcc for sm_90a);
  2. kernel A (position stage) against its plain PyTorch version on 1024,
     1000 and 3 rodent-twin states with random joint angles, and two
     launches on the same states against each other, bit for bit;
  3. kernel B (CG contact solve) against its plain version on 1024, 1000
     and 3 contact states made by kernel A, the port's collision and its
     constraints (kernel_bench.check_cg: rtol = atol = 1e-3 on every env
     against the plain version in float32; an env that misses it, at most
     0.5% of a batch, must meet the plain version run in float64 at the
     same tolerance), and two launches against each other, bit for bit;
     then the widest route, cg_kernel<0>, on 1024 contact systems of the
     CMU humanoid (56 limits and 982 contact slots: 3,984 rows) by
     kernel_bench.check_cg_widest (the median and 90th percentile of the
     envs' gap to the plain version in float64 within 3x, the largest
     within 10x, of the plain float32 solves'), bit for bit
     across two launches, with a row of its own; then kernel D (the
     constraint system of a substep, kernel B's inputs) against its plain
     version (make_constraints and cg_inputs' packing) on 1024 twin
     contact states and on 1024 with contacts and limit rows near, at and
     past where they act (rtol 1e-5, atol 1e-5 of each output's largest
     entry), bit for bit across two
     launches, timed at 1024 and 128 envs, with a row of its own; then
     kernel E (the narrowphase of every candidate pair) against the plain
     narrowphase on the CPU on 1024 states of the box, round, ellipsoid
     and convex scenes (every pair type between them), the humanoid, the
     twin and the CMU humanoid (kernel_bench.check_collision: atol 2e-5;
     the points that plane-box and box-box keep held to all their
     candidates; the convex pairs' normals and points by check_convex),
     bit for bit across two launches, timed at 1024 and 128 envs on the
     twin, the humanoid and the CMU humanoid with every instantiation's
     registers and spills, a row each and a {"kernel_e": ...} line; then
     kernel F (GAE's reverse loop) against the plain loop on the card at
     [20, 32] (the training cells' minibatch) and [20, 1024] (the
     bench's), on time-major views of
     [B, T] buffers, bit for bit and across two launches, timed behind a
     spin kernel beside the plain loop eagerly and captured as a CUDA
     graph, a row each and a {"kernel_f": ...} line;
  4. the slice: RodentTracking (twin + clip) reset for 1024 envs and a
     20-control-step generate_unroll (100 physics substeps) with the keeper
     policy, sampling from a seeded generator, each control step one
     replay of its CUDA graph (training.ActorStepGraph); A and B must each
     launch at least 100 times in it (a replay counts the launches its
     capture recorded), and every qpos, qvel and reward must be finite;
  5. kernel C (SPD sweep inverse) against its plain version on the
     (2, 1024, 73, 73) stack [qM, qM + h diag(B)] of 1024 twin states
     (the register route, tile (10, 3), which must not spill) and on SPD
     batches of 3 and 12 matrices (the JAX package's sweep-test inputs)
     for the one-warp route (n = 7, 14, 16, 27, 29, 32: the small scenes,
     the ant, the humanoid and both ends of its two instantiations), for
     the other register tiles (n = 64, 96) and for the shared-memory route
     (n = 97, 120), bitwise symmetric and the same bits from two launches;
     prints each n's route, registers and spills (the one-warp route must
     not spill) and C's route, tile, registers, spills, blocks per SM,
     time, its bound and torch.linalg.inv's time at the twin's pair;
  6. training at full width: train(...) with the arguments of
     vnl_tpu_torch/bench.py (1024 envs, networks (1024, 1024), a shortened
     episode; the control step and the SGD update replayed as CUDA graphs,
     as in every train(...) and command line below) for four training
     steps with the fused position stage
     (kernel A) and two with the unfused one (kernel C), an evaluation
     after every interval (128 envs, each control step a replay of the
     Evaluator's graph, captured at the first); losses must be finite,
     parameters must move, and the launch counts must be those of the
     chosen stage; prints the evaluation's seconds graphed (the first,
     with the capture, and a later one), the capture's seconds and nodes,
     and the seconds of one eager evaluation of the trained networks at
     the same size;
  7. the command line: the port's MJCF compiler builds the twin from
     rodent_twin.xml on the card (every field equal to
     rodent_twin_model.npz, bit for bit); `python -m vnl_tpu_torch.train`'s
     main() with vnl_tpu_torch/configs/rodent_twin_config.yaml and the
     config's own hyperparameters (128 envs, batch 32 x 32 minibatches,
     unroll 20, 16 passes, networks (1024, 1024)), the twin's clip as a
     pickle, episode length 30 and one interval of 2 training steps
     (40,960 env steps); then resumed from its last checkpoint to
     num_timesteps 61,440 (it must start at 40,960 with Adam's step count
     going on, end with finite losses and write finished params that load
     through compat.policy_from_numpy); then the multi-clip env (5 clips
     of 50 frames) with adaptive clip weights for one interval (weights
     summing to 1, every clip drawn).  Kernels A and B must launch at
     least once per physics substep of each run, C never.  Prints a
     {"cli": ...} line: env-steps/s of each run, the compile, checkpoint
     save and restore, and eval-callback seconds.
  8. the humanoid family: the port's compiler builds the committed
     dm_control humanoid (vnl_tpu_torch/assets/dm_humanoid) on the card,
     every field equal to the host's compile; kernel A against its plain
     version on 1024 humanoid states (nv 27: the one-warp route,
     position_warp_kernel<32,2>, which must be the one picked); kernel B
     on 1024 humanoid contact states (729 constraint rows: the wide route,
     cg_wide_kernel<3,1>, which must be the one picked; condim 1 and 3,
     contacts between two moving bodies) through
     kernel_bench.check_cg_reruns: check_cg's per-env test at 1e-3, with a
     budget of twice the envs the plain solve itself misses when re-run
     in float32 at one rounding, plus 0.5% (check_cg's own rule is met by
     no float32 evaluation on these states); each also bit for bit
     across two launches; kernel D on humanoid contact states as in
     phase 3 (ncon 177, condim 1 and 3; its launches also counted on the
     rollouts below); one line with the stage split of A and B at
     these shapes (and, with --old, both trees' times); HumanoidTracking and
     HumanoidStanding, wrapped for training, reset for 1024 envs and
     driven 20 control steps (graphed, as in 4) by a freshly initialised
     intention policy at the config's widths (value (1024, 1024)), A and
     B at least 100
     launches each, every qpos, qvel, reward and observation finite;
     then `python -m vnl_tpu_torch.train`'s main() with
     vnl_tpu_torch/configs/humanoid_config.yaml at the config's own sizes
     (128 envs) for one interval of one training step (episode 30), which
     must write its checkpoint and finished params;
  9. the ant: the committed gymnasium ant compiled on the card as in 8;
     kernel A on 1024 ant states (nv 14, the one-warp route
     position_warp_kernel<16,2>), bit for bit across two launches, and a
     line with its stage split (with --old, both trees' times); kernel C
     against its plain
     version on the 1024 Hessians of the first Newton iteration at ant
     contact states (n 14: the one-warp route sweep_warp_kernel<16>, no
     spills; rtol 5e-3, bitwise symmetric, two launches the same bits),
     with torch.linalg.inv's time (with --old, both trees' times in
     turns); AntTracking (Newton,
     RK4) reset for 1024 envs and driven 20 control steps as in 8: A at
     least 4 x 5 x 20 launches, C at least once per forward pass (as
     often as A), B never; then train(...) at 1024 envs, networks (1024,
     1024), for two training steps (one interval, episode 30).
 10. rendering: the overlay of phase 7's first eval-callback episode (the
     agent and its reference ghost, 320 x 240) rendered by
     SoftwareRenderer on the card, on the callback's render thread and
     stream, against the same frames rendered on the CPU (at most 0.5% of
     the pixels more than one level apart); make_egocentric_camera on a
     1024-env twin Data at 64 x 64 on the card against 8 of those envs on
     the CPU (within 1e-4 on 99.5% of the pixels); ms per overlay frame
     (card, CPU), ms per camera call, peak memory; and every render job
     the command lines of phases 7-8 started (render_eval: true) must end
     in a video file (a .gif where imageio is missing);
 11. data parallelism: train(...) at 1024 envs, the fused stage, one
     training step at the bench's hyperparameters, first without a process
     group, then with num_devices=1 under a one-rank NCCL group, where the
     gradients, the normaliser and the metrics go through all-reduces and
     assert_is_replicated and synchronize_hosts run; the params of the two
     runs must be equal bit for bit; prints env-steps/s of both, the
     all-reduces per SGD update and their device time; then the command
     line through `python -m torch.distributed.run --nproc_per_node=1 -m
     vnl_tpu_torch.train` at the twin config's sizes for one interval,
     which must exit with 0;
 12. the checkpoint tools and the examples on phase 7's first run:
     vnl_tpu_torch.eval_checkpoint.evaluate (the deterministic policy, 16
     envs over the whole clip, 245 control steps, graphed) on its last
     params file and on its last state file, and eagerly on the params
     file, which must give the same rewards and lengths bit for bit, all
     finite, every length in [1, 245], with A and B at least 5 x 245
     launches each and C none, the eager run's launches those of the
     graphed (a {"eval_checkpoint": ...} line each; the seconds both ways
     and the capture's); vnl_tpu_torch.render_checkpoint.render on the params
     file with a synthetic skin around the twin (write_twin_skin: a hull
     of 640 faces on 3 bones), which must write the diag PNG and the video
     (a .gif without imageio's mp4 backend); the first 8 skinned overlay
     frames of phase 7's first eval-callback episode on the card against
     the CPU's (phase 10's rule), with ms per frame on both and the peak
     memory; vnl_tpu_torch.examples.train_multiclip at its own sizes (32
     envs, two clips of 125 frames) for one training step, with finite
     losses and both clips drawn; a {"checkpoint_tools": ...} line;
 13. the stepping bench: vnl_tpu_torch.bench.run_stepping (the twin env
     stepped raw with random actions, no policy; each step with its draw
     one replay of its envs.StateGraph) at 1024 envs, 20 control steps a
     sample, 2 warm-up calls and 3 samples; A and B at least 100
     launches each in every sample, every qpos, qvel and reward finite;
     its JSON line ({"stepping": ...});
 14. the device-numerics check: vnl_tpu_torch.check_numerics at 1024 envs
     against the goldens vnl_tpu computed on the CPU
     (vnl_tpu_torch/assets/goldens/): the 16 envs of each rollout golden
     (twin_actions, twin_keeper with the keeper's deterministic policy in
     the loop, humanoid_actions, ant_actions) tiled to 1024 (the goldens
     of a scene stepped as one batch: the twin's two as 2048 envs), reset
     with the stored draws and stepped 20 control steps, fused and
     unfused: max
     |dqpos| over steps 1-5 within max(5e-4, 4 x the golden's own one-ulp
     spread), max |dreward| over all 20 within 1e-2, the keeper's actions
     over steps 1-5 within 1e-2; forward() on the 128 states of each forward
     golden, fused and unfused, max |dqacc| within 5e-2 x max(qacc scale,
     1); A and B (the ant: A and C) launched in every fused part, C in
     every unfused one, A never there; a drift table a golden and its
     report (check_numerics.json beside --out); then kernel C on the
     humanoid's unfused pair (2, 1024, 27, 27; the one-warp route
     sweep_warp_kernel<32>, which only this phase runs) against its plain
     version as in 5, timed with torch.linalg.inv; a {"numerics": ...}
     line (this phase runs eagerly);
 15. CUDA graphs against the eager loops, from the same seeds: the twin's
     20-step keeper rollout at 1024 envs, fused and unfused, and the 20-step
     rollouts of HumanoidTracking and AntTracking as in 8 and 9, each
     eager and graphed, every tensor of the final state and of the rollout
     (qpos, qvel, reward, action, ...) equal bit for bit; train(...) at
     the bench's hyperparameters (fused, episode 30) for two training
     steps, eager and graphed, every final parameter and buffer and every
     loss metric equal bit for bit, with an evaluation before and after
     the two steps whose metrics are equal bit for bit too (the graph,
     captured before, reads the weights the steps wrote in place); the
     twin's fused Evaluator at 128 envs x 30 steps with the keeper's
     sampling policy, two evaluations, metrics and final states;
     eval_checkpoint.evaluate on phase 7's last params file at 16 envs
     over the whole clip with fixed draws (noise=: its own graph with a
     static latent), rewards, lengths and final state; EvalCallback.rollout
     at batch 1 for 30 steps over two calls (phase 7's first and last
     params files, one generator reseeded with the call's number), each
     to the end and stopping at done, every series; each of these eager
     and graphed, with one more replay of each graph traced as below; the
     stepping bench eager and graphed,
     final states equal bit for bit; the launch counts of each pair equal;
     one more replay of each rollout's control-step graph traced with
     torch.profiler, its kernels A to F equal to the launches the
     capture counts a replay (the counts a replay adds are those the
     device ran);
     then vnl_tpu_torch.profile_rollout and profile_train (fused; the
     unfused one untraced) eager and graphed: control-step and SGD-update
     wall ms, training env-steps/s, device busy shares, the host's
     launches a control step and an update; every capture's time, node
     count and pool bytes; a {"graphs": ...} line;
 16. the port's tools beside the package: vnl_tpu_torch.bench_cliplib at
     1024 envs and 2, 8 and 64 clips of the twin's recording (each
     control step with its action draw one replay of its graph; every
     state finite, the library of the asked size, A and B at least once
     a substep), its env-steps/s a size and their flatness (min over max,
     reported, not gated); then vnl_tpu_torch.run_humanoid at 1024 envs
     with the TPU tool's hyperparameters for two intervals of two
     training steps and three graphed evaluations of 256 envs (one
     capture), which must give finite losses and move the parameters; a
     {"cliplib_humanoid": ...} line;
 17. the CMU humanoid (dm_control's CMUHumanoidPositionControlledV2020,
     vnl_tpu_torch/assets/dm_cmu_humanoid): its compile on the card equal
     to the host's; HumanoidTracking on it reset for 1024 envs and driven
     20 control steps (graphed, as in 4), kernels A, B on its widest
     route (counted as cg_widest), D and E (its convex instantiation) at
     least once a substep; a {"cmu": ...} line.
Then it prints the training env-steps/s of both configurations, the card's
name and power limit, one JSON line with a row per kernel and shape (the
twin's A, B, D, E, F and C; A, B, D and E at the humanoid's shapes; B's
widest route and E at the CMU humanoid's; A and C at the ant's; C at the
humanoid's pair) with
its launches on the paths that run that shape (phase 14 counts for each
scene it runs; B's widest route ops.launch_counts["cg_widest"] of phase
17), time per launch, plain time, bound, error, registers, shared
memory and resident blocks per SM,
every number measured in this run (the twin's rows count phase 16's
probe, the humanoid's its learning run), and last
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--out details.json] [--old DIR]
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

from vnl_tpu_torch.ops import (KERNELS, build, launch_counts,
                               reset_launch_counts, sweep)
from vnl_tpu_torch.ops import cg as cg_ops
from vnl_tpu_torch.ops import collision as col_ops
from vnl_tpu_torch.ops import constraints as con_ops
from vnl_tpu_torch.ops import gae as gae_ops
from vnl_tpu_torch.ops import position as pos
from vnl_tpu_torch.physics import collision, forward, inertia, kinematics

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 1024
OTHER_BATCHES = (1000, 3)   # also checked against the plain versions
UNROLL = 20
SEED = 0
EVAL_EPISODE = 30     # control steps per episode in phase 6 (bench: 150)
EVAL_BATCH = 128      # envs of an evaluation in phases 6 and 15 (bench's)
# published H100 SXM peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def bound_ms(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def check_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: max |err| {float(err.max()):.3e} beyond rtol {rtol} "
            f"atol {atol:.3e} at {int(bad.sum())} entries")
    return float(err.max())


def spill_bytes(name: str, kernel: str = "") -> int:
    """Largest spill reported by ptxas for the kernels of one source whose
    mangled name contains ``kernel`` (all of them by default)."""
    import re
    found = re.findall(r"Function properties for (\S+)\n[^\n]*?(\d+) bytes "
                       r"spill stores, (\d+) bytes spill loads",
                       build.BUILD_LOG.get(name, ""))
    return max([max(int(st), int(ld)) for fn, st, ld in found
                if kernel in fn] or [0])


def mangled(route: str) -> str:
    """The part of a kernel's mangled name that names its instantiation:
    "cg_wide_kernel<3,1>" -> "cg_wide_kernelILi3ELi1EE"."""
    name, args = route.rstrip(">").split("<")
    return name + "I" + "".join(f"Li{a}E" for a in args.split(",")) + "E"


def check_position(m, qpos, ker, plain):
    """Kernel A's outputs against the plain version's; returns the errors."""
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
    return errs


def same_bits(name, first, second):
    for i, (a, b) in enumerate(zip(first, second)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: output {i} differs between two "
                                 "launches on the same inputs")


def phase_kernel_a(m, gen, name="position", other_batches=OTHER_BATCHES):
    """Kernel A against its plain version on BATCH random states of ``m``
    (and ``other_batches``); returns (kernels row, errors)."""
    from vnl_tpu_torch.kernel_bench import QUEUED, random_states, time_ms
    qpos = random_states(m, BATCH, gen)
    ker = pos._launch(m, qpos)
    plain = pos.position_plain(m, qpos)
    torch.cuda.synchronize()
    errs = check_position(m, qpos, ker, plain)
    same_bits(name, ker, pos._launch(m, qpos))
    for batch in other_batches:
        q = random_states(m, batch, gen)
        errs[f"batch_{batch}"] = max(check_position(
            m, q, pos._launch(m, q), pos.position_plain(m, q)).values())
    ms = time_ms(lambda: pos._launch(m, qpos), queued=QUEUED)
    plain_ms = time_ms(lambda: pos.position_plain(m, qpos), reps=5)
    nmat = 2 if inertia.needs_implicit_damping(m) else 1
    out_floats = sum(int(np.prod(s)) for s in pos.output_shapes(m))
    nbytes = BATCH * 4 * (m.nq + out_floats)
    flops = BATCH * 2 * nmat * m.nv ** 3    # the sweeps; the rest is < 5%
    b_ms, b_by = bound_ms(nbytes, flops)
    res = pos.resources(m)
    return dict(name=name, kernel="position", route="cuda",
                shape=dict(batch=BATCH, nq=m.nq, nv=m.nv, nbody=m.nbody,
                           tile=list(pos.tile_shape(m.nv)),
                           instantiation=pos.route_name(m)),
                source="vnl_tpu_torch/csrc/position.cu",
                replaces="vnl_tpu/ops/pallas_position.py:229",
                max_abs_err=max(v for k, v in errs.items()
                                if k in pos.OUTPUT_NAMES),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, regs=res["regs"], smem_bytes=res["smem_bytes"],
                blocks_per_sm=res["blocks_per_sm"],
                local_bytes=res["local_bytes"],
                spill_bytes=spill_bytes("position",
                                        mangled(pos.route_name(m)))), errs


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


CG_OUT = ("qacc", "qfrc_constraint", "con_f")


def phase_kernel_b(m, gen, name="cg", other_batches=OTHER_BATCHES,
                   press=0.005, reruns=False):
    """Kernel B against its plain version on BATCH contact states of ``m``,
    the root lowered by ``press`` (and on ``other_batches``), by
    kernel_bench.check_cg, or with ``reruns`` by check_cg_reruns (the same
    per-env tolerance, with a budget of twice the envs that the plain
    solve itself misses when re-run at one rounding); returns (kernels
    row, errors)."""
    from vnl_tpu_torch.kernel_bench import (QUEUED, check_cg, check_cg_reruns,
                                            contact_states, time_ms)
    (args, st), active = contact_states(m, BATCH, gen, press)
    ker = cg_ops._launch(st, args)
    torch.cuda.synchronize()
    if reruns:
        errs = check_cg_reruns(st, args, ker)      # rtol = atol = 1e-3
        unstable = None
    else:
        errs = check_cg(st, args, ker)             # rtol = atol = 1e-3
        unstable = errs["unstable_envs"]
    off = errs["off_envs"]
    same_bits(name, ker, cg_ops._launch(st, args))
    for batch in other_batches:
        (a, s), _ = contact_states(m, batch, gen, press)
        e = check_cg(s, a, cg_ops._launch(s, a))
        errs[f"batch_{batch}"] = e
        off, unstable = off + e["off_envs"], unstable + e["unstable_envs"]
    ms = time_ms(lambda: cg_ops._launch(st, args), queued=QUEUED)
    plain_ms = time_ms(lambda: cg_ops.cg_plain(*args, statics=st), reps=5)
    b_ms, b_by = bound_ms(*cg_cost(st, args))
    res = cg_ops.resources(st, m.device)
    return dict(name=name, kernel="cg", route="cuda",
                shape=dict(batch=BATCH, nv=st.nv, ncon=st.ncon,
                           nlimit=st.nlimit, rows=st.nlimit + 4 * st.ncon,
                           instantiation=cg_ops.kernel_name(st)),
                source="vnl_tpu_torch/csrc/cg.cu",
                replaces="vnl_tpu/ops/pallas_cg.py:74",
                max_abs_err=max(errs[n] for n in CG_OUT),
                ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                regs=res["regs"], smem_bytes=res["smem_bytes"],
                blocks_per_sm=res["blocks_per_sm"],
                local_bytes=res["local_bytes"],
                spill_bytes=spill_bytes("cg", mangled(cg_ops.kernel_name(st))),
                # envs of the three batches held to the float64 plain solve,
                # and envs on which the plain solve differs from itself
                checked_envs=BATCH + sum(other_batches), off_envs=off,
                unstable_envs=unstable), \
        dict(errs, active_contacts=active, ncon=st.ncon, nlimit=st.nlimit)


def constraints_bytes(m, batch, nlimit, ncon, nroot):
    """Bytes kernel D moves for ``batch`` envs: reads qpos at the limit
    rows, qvel, cdof, the subtree coms of the contacts' roots and the
    contacts; writes g36 and the row arrays (the tables, one copy for
    every env, stay in L2)."""
    reads = nlimit + 7 * m.nv + 3 * nroot + 13 * ncon
    writes = 36 * ncon + 4 * max(nlimit, 1) + 9 * ncon
    return 4 * batch * (reads + writes)


def phase_kernel_d(m, gen, name="constraints", press=0.005):
    """Kernel D against its plain version on BATCH contact states of ``m``
    (the root lowered by ``press``) and on BATCH with the edges of
    kernel_bench.constraint_states, and bit for bit across two launches;
    timed at BATCH and 128 envs.  Returns (kernels row, errors)."""
    from vnl_tpu_torch.kernel_bench import (QUEUED, constraint_states,
                                            time_ms)
    errs, timed = {}, {}
    for edges in (False, True):
        args = (m,) + constraint_states(m, BATCH, gen, press, edges)
        ker = con_ops.constraints(*args)
        plain = con_ops.constraints_plain(*args)
        torch.cuda.synchronize()
        for out, k, p in zip(con_ops.OUTPUT_NAMES, ker, plain):
            e = check_close(out, k, p, 1e-5, 1e-5 * float(p.abs().max()))
            errs[f"{out}_edges" if edges else out] = e
        errs["g36_same_bits" + ("_edges" if edges else "")] = \
            bool(torch.equal(ker[0], plain[0]))
        same_bits(name, ker, con_ops.constraints(*args))
    for batch in (BATCH, 128):
        args = (m,) + constraint_states(m, batch, gen, press)
        timed[batch] = (
            time_ms(lambda: con_ops.constraints(*args), queued=QUEUED),
            time_ms(lambda: con_ops.constraints_plain(*args), reps=5))
    pair = args[-1]
    t = con_ops.kernel_tables(m, pair)
    nlimit, ncon = len(t["lim_dof"]), len(pair)
    nroot = len(np.unique(t["con_int"][:2]))
    b_ms, b_by = bound_ms(constraints_bytes(m, BATCH, nlimit, ncon, nroot),
                          0)
    res = con_ops.resources(m, pair)
    row = dict(name=name, kernel="constraints", route="cuda",
               shape=dict(batch=BATCH, nv=m.nv, ncon=ncon, nlimit=nlimit,
                          groups=len(t["grp_start"]) - 1),
               source="vnl_tpu_torch/csrc/constraints.cu",
               replaces="vnl_tpu_torch/physics/constraint.py "
                        "make_constraints + ops/cg.py cg_inputs",
               max_abs_err=max(v for v in errs.values()
                               if not isinstance(v, bool)),
               ms=timed[BATCH][0], plain_ms=timed[BATCH][1],
               ms_128=timed[128][0], plain_ms_128=timed[128][1],
               bound_ms=b_ms, bound_by=b_by,
               bound_ms_128=bound_ms(constraints_bytes(
                   m, 128, nlimit, ncon, nroot), 0)[0],
               library_ms=None, regs=res["regs"],
               smem_bytes=res["smem_bytes"],
               blocks_per_sm=res["blocks_per_sm"],
               local_bytes=res["local_bytes"],
               spill_bytes=spill_bytes("constraints"))
    print(json.dumps({"kernel_d": {k: row[k] for k in (
        "name", "shape", "max_abs_err", "ms", "ms_128", "plain_ms",
        "plain_ms_128", "bound_ms", "bound_ms_128", "regs", "local_bytes",
        "blocks_per_sm")}}), flush=True)
    return row, errs


def collision_bytes(m, batch):
    """Bytes kernel E moves for ``batch`` envs: reads the position and
    rotation of each geom a candidate pair names, writes each contact
    slot's distance, point and frame (the pair tables, one copy for every
    env, stay in L2)."""
    pair = collision.pair_expansion(m)
    geoms = np.unique(np.concatenate([np.asarray(m.pair_geom1)[pair],
                                      np.asarray(m.pair_geom2)[pair]]))
    return 4 * batch * (12 * len(geoms) + 13 * len(pair))


# kernel E's scenes: every pair type between the first four
E_SCENES = ("boxes", "round", "ellipsoid", "convex", "humanoid", "twin",
            "cmu")
# the scenes whose kernel E is timed, and their rows' names
E_ROWS = dict(twin="collision", humanoid="collision_humanoid",
              cmu="collision_cmu")


def phase_kernel_e(device, gen):
    """Kernel E against the plain narrowphase on the CPU
    (kernel_bench.check_collision) on BATCH states of each of E_SCENES, and
    bit for bit across two launches; on E_ROWS's scenes timed at BATCH and
    128 envs, beside the plain version on the card.  Returns (kernels
    rows, errors)."""
    from vnl_tpu_torch import compat, kernel_bench as kb, mjcf
    xml = dict(boxes=kb.BOX_SCENE, round=kb.ROUND_SCENE,
               ellipsoid=kb.ELLIPSOID_SCENE, convex=kb.CONVEX_SCENE,
               humanoid=compat.DM_HUMANOID_XML, cmu=compat.CMU_HUMANOID_XML)

    def model(name, dev):
        if name == "twin":
            return compat.model_from_numpy(compat.TWIN_MODEL, device=dev)
        return mjcf.load_model(xml[name], device=dev)

    def data(m, name, batch):
        if name == "twin":
            qpos = kb.random_states(m, batch, gen)
            qpos[:, 2] -= 0.02
        else:
            qpos = torch.as_tensor(kb.collision_states(
                m.qpos0.cpu().numpy(), m.jnt_range.cpu().numpy(),
                name in ("humanoid", "cmu"), SEED + batch, batch),
                device=device)
        return kinematics.kinematics(m, forward.make_data(m, batch,
                                                          qpos=qpos))

    errs, rows = {}, []
    for name in E_SCENES:
        m = model(name, device)
        d = data(m, name, BATCH)
        gx, gm = d.geom_xpos.contiguous(), d.geom_xmat.contiguous()
        ker = col_ops._launch(m, gx, gm)
        same_bits(f"collision {name}", ker[:3],
                  col_ops._launch(m, gx, gm)[:3])
        errs[name] = dict(kb.check_collision(
            ker, model(name, "cpu"), d.replace(
                qpos=d.qpos.cpu(), geom_xpos=gx.cpu(), geom_xmat=gm.cpu()),
            flat_env=name == "boxes"), active=int((ker[0] < 0).sum()))
        if name not in E_ROWS:
            continue
        timed = {}
        for batch in (BATCH, 128):
            db = data(m, name, batch)
            x, r = db.geom_xpos.contiguous(), db.geom_xmat.contiguous()
            timed[batch] = (
                kb.time_ms(lambda: col_ops._launch(m, x, r),
                           queued=kb.QUEUED),
                kb.time_ms(lambda: collision.collide(m, db), reps=5))
        res = col_ops.resources(m)
        took = res[res["takes"]]
        t = col_ops.kernel_tables(m)
        rows.append(dict(
            name=E_ROWS[name], kernel="collision", route="cuda",
            shape=dict(batch=BATCH, npair=len(t["pair"]),
                       ncon=len(t["con_pair"]),
                       instantiation=e_instantiation(t["route"])),
            source="vnl_tpu_torch/csrc/collision.cu",
            replaces="vnl_tpu_torch/physics/collision.py collide",
            max_abs_err=max(errs[name][k] for k in ("dist", "pos", "frame")
                            if k in errs[name]),
            ms=timed[BATCH][0], plain_ms=timed[BATCH][1],
            ms_128=timed[128][0], plain_ms_128=timed[128][1],
            bound_ms=bound_ms(collision_bytes(m, BATCH), 0)[0],
            bound_by="bytes",
            bound_ms_128=bound_ms(collision_bytes(m, 128), 0)[0],
            library_ms=None, regs=took["regs"],
            smem_bytes=took["smem_bytes"],
            blocks_per_sm=took["blocks_per_sm"],
            local_bytes=took["local_bytes"],
            spill_bytes=spill_bytes("collision",
                                    e_mangled(t["route"])),
            instantiations={k: dict(res[k], spill_bytes=spill_bytes(
                "collision", e_mangled(r)))
                for k, r in col_ops.ROUTES.items()}))
    print(json.dumps({"kernel_e": dict(errors=errs, rows=[{k: r[k] for k in (
        "name", "shape", "ms", "ms_128", "plain_ms", "plain_ms_128",
        "bound_ms", "bound_ms_128", "regs", "local_bytes", "blocks_per_sm",
        "instantiations")} for r in rows])}), flush=True)
    return rows, errs


def e_instantiation(route: int) -> str:
    """Kernel E's instantiation of ``route`` (ops/collision.py ROUTES:
    bit 0 kBoxes, bit 1 kConvex), as the trace names it."""
    return "collision_kernel<%s, %s>" % tuple(
        "true" if route & bit else "false" for bit in (1, 2))


def e_mangled(route: int) -> str:
    """The part of that instantiation's mangled name that names it."""
    return "ILb%dELb%dEE" % (route & 1, route >> 1 & 1)


# kernel F's shapes: the training cells' minibatch and the bench's
F_SHAPES = ((20, 32), (20, 1024))


def gae_bytes(T, B):
    """Bytes kernel F moves: reads truncation, termination, reward and
    value of every step and the bootstrap value, writes targets and
    advantages."""
    return 4 * (4 * T * B + B + 2 * T * B)


def gae_inputs(T, B, gen):
    """Kernel F's inputs as the loss hands them over: time-major views of
    [B, T] buffers, a quarter of the steps done, half of those truncated;
    and a bootstrap value."""
    done = torch.rand(B, T, generator=gen, device="cuda") < 0.25
    cut = torch.rand(B, T, generator=gen, device="cuda") < 0.5
    rows = [(done & cut).float(), (done & ~cut).float(),
            torch.rand(B, T, generator=gen, device="cuda"),
            torch.randn(B, T, generator=gen, device="cuda")]
    return [x.transpose(0, 1) for x in rows] + [
        torch.randn(B, generator=gen, device="cuda")]


def phase_kernel_f(gen):
    """Kernel F against the plain loop on the card at F_SHAPES, bit for
    bit, and across two launches; timed behind a spin kernel beside the
    plain loop eagerly and as a CUDA graph of its nodes (what it cost an
    SGD update's graph).  Returns (kernels rows, errors)."""
    from vnl_tpu_torch.kernel_bench import QUEUED, time_ms
    kw = dict(lambda_=0.95, discount=0.9)       # the cells' loss
    rows, errs = [], {}
    res = gae_ops.resources()
    for T, B in F_SHAPES:
        x = gae_inputs(T, B, gen)
        ker = gae_ops._launch(*x, **kw)
        plain = gae_ops.compute_gae_plain(*x, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(k, p) for k, p in zip(ker, plain)):
            err = max(float((k - p).abs().max()) for k, p in zip(ker, plain))
            raise AssertionError(f"gae {T}x{B}: kernel F differs from the "
                                 f"plain loop by up to {err}")
        errs[f"{T}x{B}"] = dict(same_bits=True)
        same_bits(f"gae {T}x{B}", ker, gae_ops._launch(*x, **kw))
        graph = torch.cuda.CUDAGraph()
        gae_ops.compute_gae_plain(*x, **kw)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            gae_ops.compute_gae_plain(*x, **kw)
        b_ms, b_by = bound_ms(gae_bytes(T, B), 14 * T * B)
        rows.append(dict(
            name="gae" if B == 32 else f"gae_{B}", kernel="gae",
            route="cuda", shape=dict(T=T, B=B),
            source="vnl_tpu_torch/csrc/gae.cu",
            replaces="vnl_tpu_torch/ops/gae.py compute_gae_plain",
            max_abs_err=0.0,
            ms=time_ms(lambda: gae_ops._launch(*x, **kw), queued=QUEUED),
            plain_ms=time_ms(lambda: gae_ops.compute_gae_plain(*x, **kw),
                             reps=5),
            plain_graph_ms=time_ms(graph.replay, queued=QUEUED),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            regs=res["regs"], smem_bytes=res["smem_bytes"],
            blocks_per_sm=res["blocks_per_sm"],
            local_bytes=res["local_bytes"], spill_bytes=spill_bytes("gae")))
        del graph
    print(json.dumps({"kernel_f": dict(errors=errs, rows=[{k: r[k] for k in (
        "name", "shape", "ms", "plain_ms", "plain_graph_ms", "bound_ms",
        "bound_by", "regs", "local_bytes", "spill_bytes", "blocks_per_sm")}
        for r in rows])}), flush=True)
    return rows, errs


def phase_kernel_b_widest(gen):
    """Kernel B's widest route, cg_kernel<0> (more than 1,024 contact rows
    or 256 limit rows), at the CMU humanoid's system (56 limits and 982
    contact slots: 3,984 rows) on BATCH contact states, by
    kernel_bench.check_cg_widest, and bit for bit across two launches;
    returns (kernels row, errors).  Its launches are those of phase 17's
    paths."""
    from vnl_tpu_torch.kernel_bench import (QUEUED, check_cg_widest,
                                            contact_states, scene, time_ms)
    m, kw = scene("cmu")
    (args, st), active = contact_states(m, BATCH, gen, press=kw["press"])
    name = cg_ops.kernel_name(st)
    if name != "cg_kernel<0>" or st.nlimit + 4 * st.ncon != 3984:
        raise AssertionError(f"the CMU humanoid takes {name} at "
                             f"{st.nlimit + 4 * st.ncon} rows")
    ker = cg_ops._launch(st, args)
    torch.cuda.synchronize()
    errs = check_cg_widest(st, args, ker)
    plain = cg_ops.cg_plain(*args, statics=st)
    errs.update({n: float((k - w).abs().max())
                 for n, k, w in zip(CG_OUT, ker, plain)})
    same_bits("cg_widest", ker, cg_ops._launch(st, args))
    ms = time_ms(lambda: cg_ops._launch(st, args), queued=QUEUED)
    plain_ms = time_ms(lambda: cg_ops.cg_plain(*args, statics=st), reps=5)
    b_ms, b_by = bound_ms(*cg_cost(st, args))
    res = cg_ops.resources(st, m.device)
    row = dict(name="cg_widest_cmu", kernel="cg", route="cuda",
               shape=dict(batch=BATCH, nv=st.nv, ncon=st.ncon,
                          nlimit=st.nlimit, rows=st.nlimit + 4 * st.ncon,
                          instantiation=name),
               source="vnl_tpu_torch/csrc/cg.cu",
               replaces="vnl_tpu/ops/pallas_cg.py:74",
               max_abs_err=max(errs[n] for n in CG_OUT),
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, regs=res["regs"],
               smem_bytes=res["smem_bytes"],
               blocks_per_sm=res["blocks_per_sm"],
               local_bytes=res["local_bytes"],
               spill_bytes=spill_bytes("cg", mangled(name)),
               checked_envs=BATCH,
               gap_quantiles=dict(q=[0.5, 0.9, 1.0], kernel=errs["kernel"],
                                  plain=errs["plain"]),
               counter="cg_widest")
    print(json.dumps({"kernel_b_widest": {k: row[k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "regs",
        "local_bytes", "spill_bytes", "smem_bytes", "gap_quantiles")}
        | dict(active_contacts=active)}), flush=True)
    return row, dict(errs, active_contacts=active)


def unroll(env, make_policy, graphed, again=False):
    """``env`` reset for BATCH envs from a generator seeded with SEED and
    driven UNROLL control steps by the policy ``make_policy(state)``
    (sampling from that generator), eagerly or replayed as the
    control-step graph (training.ActorStepGraph); with ``again`` a second
    unroll of the graph is timed after it (its steady state; the returned
    state is a copy taken before).  Returns dict(counts: the launches of
    the reset and the first unroll, state, rollout, reset_s, unroll_s,
    again_s, graph: the capture's report, and with ``again`` profiled:
    ``profiled_launches`` of one more replay)."""
    from vnl_tpu_torch.training import ActorStepGraph, generate_unroll
    from vnl_tpu_torch.utils import graphs
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = env.reset(BATCH, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    policy = make_policy(state)
    step = ActorStepGraph(env, policy, gen) if graphed else None
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state, rollout = generate_unroll(env, state, policy, gen, UNROLL,
                                     step=step)
    torch.cuda.synchronize()
    out = dict(counts=dict(launch_counts), state=state, rollout=rollout,
               reset_s=t1 - t0, unroll_s=time.perf_counter() - t2,
               again_s=None, graph=step.report if step else None)
    if again and graphed:
        out["state"] = graphs.clone(state)
        t0 = time.perf_counter()
        generate_unroll(env, state, policy, gen, UNROLL, step=step)
        torch.cuda.synchronize()
        out["again_s"] = time.perf_counter() - t0
        out["profiled"] = profiled_launches(
            lambda: generate_unroll(env, state, policy, gen, 1, step=step))
    return out


# the launch counters of kernels A to F, and the group by which
# profile_rollout.device_groups names each kernel's routes
COUNTED_GROUPS = tuple((k.name, k.label) for k in KERNELS.values())


def profiled_launches(run) -> dict:
    """The launches of kernels A to F on the device while ``run()``
    runs, by launch counter, counted in a torch.profiler trace of it: for
    a graph replay, the kernels that really ran, beside the counts that
    ops.ReplayCounts adds for it from its capture."""
    from torch.profiler import ProfilerActivity, profile
    from vnl_tpu_torch.profile_rollout import device_groups
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    _, launches = device_groups(prof)
    return {counter: launches[group] for counter, group in COUNTED_GROUPS}


def keeper_policy(state):
    from vnl_tpu_torch import compat
    from vnl_tpu_torch.models import make_inference_fn
    return make_inference_fn(compat.policy_from_numpy(
        compat.KEEPER_POLICY, device="cuda"))(deterministic=False)


def phase_rollout(device):
    from vnl_tpu_torch.envs import make_twin_env
    env = make_twin_env(device=device)
    run = unroll(env, keeper_policy, graphed=True)
    counts, state, rollout = run["counts"], run["state"], run["rollout"]
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
        reset_s=run["reset_s"], unroll_s=run["unroll_s"],
        env_steps_per_s=BATCH * UNROLL / run["unroll_s"], graph=run["graph"],
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


# Kernel C's other inputs, beside the twin's pair (n = 73, tile (10, 3)):
# the one-warp route at n = 7 (box_chain, ball_arm), 14 (the ant), 16, 27
# (the humanoid), 29 and 32; the register tiles at 64 ((8, 2)) and 96
# (star96: (12, 3)); the shared-memory route at 97 and 120; each at an odd
# and an even count of matrices.
SWEEP_NS = (7, 14, 16, 27, 29, 32, 64, 96, 97, 120)
SWEEP_COUNTS = (3, 12)


def check_sweep(name, a, errs):
    """Kernel C on ``a`` against the plain version at rtol 5e-3 and atol
    1e-4 of the inverse's scale, |A X - I| < 5e-3, bitwise symmetric, the
    same bits from two launches; records the errors in ``errs``."""
    plain = sweep.inv_spd_sweep_plain(a)
    scale = float(plain.abs().max())
    eye = torch.eye(a.shape[-1], device="cuda")
    ker = sweep._launch(a)
    errs[name] = check_close(name, ker, plain, 5e-3, 1e-4 * scale)
    resid = float((a @ ker - eye).abs().max())
    if not resid < 5e-3:
        raise AssertionError(f"{name}: |A X - I| = {resid:.3e}")
    errs[name + "_resid"] = resid
    if not torch.equal(ker, ker.transpose(-1, -2)):
        raise AssertionError(f"{name}: output not bitwise symmetric")
    same_bits(name, [ker], [sweep._launch(a)])


def sweep_kernel_name(route) -> str:
    """The part of kernel C's mangled name that names a route's
    instantiation."""
    if route.kind == "warp":
        return "sweep_warp_kernelILi{}EE".format(route.tile[0])
    if route.kind == "register":
        return "sweep_tile_kernelILi{}ELi{}EE".format(*route.tile)
    return "sweep_kernelP"


def sweep_route_report(n: int, kind: str) -> dict:
    """Kernel C's route for n, its registers, local bytes and spills
    (ptxas's report where this run built it); raises if the route is not
    ``kind`` or, on the register and one-warp routes, if it spills or
    keeps local memory."""
    route, res = sweep.route(n), sweep.resources(n)
    spill = spill_bytes("sweep", sweep_kernel_name(route))
    if route.kind != kind or (kind != "shared" and
                              (spill or res["local_bytes"])):
        raise AssertionError(f"kernel C for n = {n}: {route}, {spill} "
                             f"spill bytes, {res['local_bytes']} local bytes")
    return dict(res, spill_bytes=spill)


def phase_kernel_c(m, gen):
    from vnl_tpu_torch.kernel_bench import (QUEUED, random_states, time_ms,
                                            twin_pair)
    route, res = sweep.route(m.nv), sweep.resources(m.nv)
    # the main path's kernel: a register tile with no spills and no local
    # memory at all
    sweep_route_report(m.nv, "register")
    pair = twin_pair(m, random_states(m, BATCH, gen))   # (2, B, nv, nv)
    errs = {}
    check_sweep("twin_pair", pair, errs)
    routes = {}
    for n in SWEEP_NS:
        r = sweep.route(n)
        routes[n] = sweep_route_report(n, r.kind)
        if (r.kind == "warp") != (n <= 32):
            raise AssertionError(f"kernel C for n = {n}: {r}")
        for count in SWEEP_COUNTS:
            check_sweep(f"spd_{count}x{n}", spd_batch(count, n, gen), errs)
    print(json.dumps({"kernel_c_routes": {
        n: {k: r[k] for k in ("route", "tile", "regs", "local_bytes",
                              "spill_bytes", "threads", "blocks_per_sm")}
        for n, r in routes.items()}}), flush=True)
    ms = time_ms(lambda: sweep._launch(pair), queued=QUEUED)
    wide = spd_batch(pair.numel() // m.nv ** 2, 120, gen)
    shared_ms = time_ms(lambda: sweep._launch(wide), queued=QUEUED)
    plain_ms = time_ms(lambda: sweep.inv_spd_sweep_plain(pair), reps=5)
    flat = pair.reshape(-1, m.nv, m.nv)
    library_ms = time_ms(lambda: torch.linalg.inv(flat), reps=10)
    nmat = flat.shape[0]
    b_ms, b_by = bound_ms(2 * nmat * m.nv ** 2 * 4, nmat * 2 * m.nv ** 3)
    row = dict(name="sweep", kernel="sweep", route="cuda",
               shape=dict(batch=list(pair.shape[:2]), n=m.nv,
                          tile=list(route.tile)),
               source="vnl_tpu_torch/csrc/sweep.cu",
               replaces="vnl_tpu/ops/pallas_linalg.py:49",
               max_abs_err=errs["twin_pair"], ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
               regs=res["regs"], smem_bytes=res["smem_bytes"],
               blocks_per_sm=res["blocks_per_sm"],
               local_bytes=res["local_bytes"],
               # the largest over every tile and both routes
               spill_bytes=spill_bytes("sweep"),
               kernel_route=route.kind, tile=list(route.tile),
               # the shared-memory route on as many matrices of n = 120
               shared_route_ms_n120=shared_ms)
    print(json.dumps({"kernel_c": {k: row[k] for k in (
        "kernel_route", "tile", "regs", "spill_bytes", "blocks_per_sm", "ms",
        "bound_ms", "library_ms", "shared_route_ms_n120")}}), flush=True)
    return row, errs


def eval_both_ways(net, fused: bool, graph_reports) -> dict:
    """The evaluation seconds of phase 6 both ways: the graphed run's
    (its graph's captures in ``graph_reports``), beside one eager
    evaluation of the trained networks at the same size (128 envs x
    EVAL_EPISODE steps)."""
    from vnl_tpu_torch import models
    from vnl_tpu_torch.envs import make_twin_env, wrap_for_training
    from vnl_tpu_torch.training import Evaluator
    device = next(net.parameters()).device
    evaluator = Evaluator(
        wrap_for_training(make_twin_env(device=device, fused_position=fused),
                          episode_length=EVAL_EPISODE),
        models.make_inference_fn(net)(deterministic=False),
        num_eval_envs=EVAL_BATCH, episode_length=EVAL_EPISODE,
        action_repeat=1,
        generator=torch.Generator(device=device).manual_seed(SEED + 6),
        cuda_graphs=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluator.run_evaluation({})
    torch.cuda.synchronize()
    captures = [g for g in graph_reports if g["name"] == "eval_step"]
    return dict(eager_s=time.perf_counter() - t0,
                capture_s=[g["capture_s"] + g["instantiate_s"]
                           for g in captures],
                nodes=[g["nodes"] for g in captures])


def phase_training(fused: bool, steps: int):
    """train(...) at the bench's widths; returns (launch counts, report)."""
    from vnl_tpu_torch import bench, models
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
    rep["evaluation"] = dict(eval_both_ways(made["net"], fused,
                                            rep["graphs"]),
                             graphed_s=rep["eval_s"],
                             graphed_first_s=rep["first_eval_s"])
    print(json.dumps({"training": {k: v for k, v in rep.items()
                                   if k != "metrics"}}), flush=True)
    return counts, rep


TWIN_XML = os.path.join(ROOT, "vnl_tpu_torch", "assets", "rodent_twin.xml")
CLI_DIR = os.path.join(ROOT, "build", "cli_smoke")      # gitignored
CLI_SETTINGS = ["train.episode_length=30", "train.num_timesteps=40960",
                "train.eval_every=20480"]


def check_compile(compile_fn, want, device, label):
    """Runs ``compile_fn`` (the port's compiler, an MJCF to a Model on the
    card) and holds every field against ``want`` (numpy fields), bit for
    bit; returns (the Model, the compile's seconds)."""
    import dataclasses
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = compile_fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    seen = set()
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if f.name == "cache":
            continue
        if f.name == "skin_file":      # a field only for a model with one
            if v != (str(want[f.name]) if f.name in want else None):
                raise AssertionError(f"skin_file of {label}: {v}")
            seen.update({f.name} & set(want))
            continue
        if f.name == "opt":
            for g in dataclasses.fields(v):
                w = want[f"opt_{g.name}"]
                if not np.array_equal(np.asarray(getattr(v, g.name)), w):
                    raise AssertionError(f"opt.{g.name} differs")
                seen.add(f"opt_{g.name}")
            continue
        w = want[f.name]
        seen.add(f.name)
        if torch.is_tensor(v):
            if v.device.type != torch.device(device).type:
                raise AssertionError(f"{f.name} is not on {device}")
            got = v.cpu().numpy()
            same = got.dtype == w.dtype and got.shape == w.shape and \
                got.tobytes() == w.tobytes()
        elif isinstance(v, np.ndarray):
            same = v.dtype == w.dtype and v.tobytes() == w.tobytes()
        else:
            same = np.array_equal(np.asarray(v), w)
        if not same:
            raise AssertionError(f"compiled field {f.name} of {label} "
                                 "differs")
    if seen != set(want):
        raise AssertionError(f"fields not compared: {set(want) ^ seen}")
    return m, seconds


def check_twin_compile(device) -> float:
    """The twin from rodent_twin.xml, as compile_rodent builds it, against
    rodent_twin_model.npz; returns the compile's seconds."""
    from vnl_tpu_torch import compat
    from vnl_tpu_torch.envs import compile_rodent
    with np.load(compat.TWIN_MODEL) as z:
        want = {k: z[k] for k in z.files}
    return check_compile(lambda: compile_rodent(TWIN_XML, device=device),
                         want, device, "rodent_twin.xml")[1]


def check_scene_compile(path, overrides, device):
    """A committed third-party scene compiled onto the card, every field
    equal to the same compile on the host (numpy); returns (Model, s)."""
    from vnl_tpu_torch import mjcf
    want = mjcf.compile_numpy(mjcf.load_spec(path, overrides=overrides))
    return check_compile(
        lambda: mjcf.load_model(path, overrides=overrides, device=device),
        want, device, os.path.basename(path))


def _records(log_dir):
    """The metrics records of the one run logged in ``log_dir``."""
    import glob
    (path,) = glob.glob(os.path.join(log_dir, "metrics_*.jsonl"))
    with open(path) as f:
        return [json.loads(line) for line in f][1:]


def check_cli_launches(tag, counts, substeps):
    """A and B at least once per physics substep of a run, C never."""
    a, b, c = (counts.get(k, 0) for k in ("position", "cg", "sweep"))
    if a < substeps or b < substeps or c:
        raise AssertionError(f"{tag}: launches A {a}, B {b}, C {c} for "
                             f"{substeps} physics substeps")


TWIN_ARGS = [f"env_config={ROOT}/vnl_tpu_torch/configs/rodent_twin_config.yaml",
             f"env.clip_path={CLI_DIR}/twin_clip.p",
             f"env.env_args.mjcf_path={TWIN_XML}"]


CALLBACKS = []     # every EvalCallback the command lines made, in order


def recording_eval_callback(*a, **kw):
    """The command line's EvalCallback, recorded with its last episode in
    CALLBACKS, for phase 10."""
    from vnl_tpu_torch.training.eval_callback import EvalCallback

    class Recording(EvalCallback):
        def rollout(self, *ra, **rkw):
            self.last_traj = super().rollout(*ra, **rkw)
            return self.last_traj

    cb = Recording(*a, **kw)
    CALLBACKS.append(cb)
    return cb


def run_cli(tag, extra, device, expect_from=0, env_args=TWIN_ARGS):
    """main() of the command line with an env config (``env_args``, the
    twin's by default); returns (report, launch counts, run dir, last
    metrics record).  Checks the run's env steps, finite losses, and A
    and B launched at least once per physics substep."""
    import glob
    from vnl_tpu_torch import train as cli
    log_dir = os.path.join(CLI_DIR, tag, "logs")
    args = env_args + [f"train.checkpoint_dir={CLI_DIR}/{tag}/ck",
                       f"train.log_dir={log_dir}"] + CLI_SETTINGS + extra
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    cli.EvalCallback = recording_eval_callback
    _, _, metrics = cli.main(args, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    (run,) = glob.glob(os.path.join(CLI_DIR, tag, "ck", "*"))
    recs = _records(log_dir)
    evals = [r for r in recs if "eval/episode_reward" in r]
    diags = [r for r in recs if "diag/rtrunk_mean" in r]
    last = evals[-1]
    bad = [k for k, v in last.items() if k.startswith("training/")
           and not np.isfinite(v)]
    if bad or "training/total_loss" not in last:
        raise AssertionError(f"{tag}: non-finite or missing losses {bad}")
    trained = last["_step"] - expect_from
    # physics substeps: the training envs (128) by control step, then each
    # evaluation (128 envs) and each eval-callback episode (1 env)
    substeps = 5 * (trained // 128 + 30 * (len(evals) + len(diags)))
    check_cli_launches(tag, counts, substeps)
    return dict(env_steps_per_s=last["training/sps"],
                rollout_s_per_training_step=last[
                    "training/rollout_s_per_step"],
                sgd_s_per_training_step=last["training/sgd_s_per_step"],
                first_step=evals[0]["_step"], last_step=last["_step"],
                eval_s=last["eval/epoch_eval_time"],
                eval_callback_s=[d["diag/eval_callback_s"] for d in diags],
                substeps=substeps, wall_s=wall,
                total_loss=last["training/total_loss"]), counts, run, last


def phase_cli(device):
    """Phase 7; returns (report, launch counts of each run)."""
    import shutil
    from vnl_tpu_torch import compat
    from vnl_tpu_torch.data import save_clip_pickle
    from vnl_tpu_torch.envs import RodentMultiClipTracking
    from vnl_tpu_torch.training import checkpoint
    t_phase = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    os.makedirs(CLI_DIR)
    rep = {"compile_s": check_twin_compile(device)}
    save_clip_pickle(os.path.join(CLI_DIR, "twin_clip.p"),
                     compat.clip_from_numpy(compat.TWIN_CLIP, device="cpu"))

    rep["train"], c1, run, _ = run_cli("train", [], device)
    ckpt = checkpoint.latest_checkpoint(os.path.join(run, "state"))
    if not ckpt or not ckpt.endswith("/40960.npz"):
        raise AssertionError(f"final checkpoint {ckpt}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = checkpoint.restore(ckpt, device=device)
    torch.cuda.synchronize()
    rep["restore_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checkpoint.save(os.path.join(CLI_DIR, "timing"), state.env_steps, state)
    rep["save_s"] = time.perf_counter() - t0
    updates = state.optimizer_state["step"]
    if state.env_steps != 40960 or updates != 2 * 16 * 32:
        raise AssertionError(f"checkpoint: env_steps {state.env_steps}, "
                             f"Adam step {updates}")

    rep["resume"], c2, run2, _ = run_cli(
        "resume", ["train.num_timesteps=61440",
                   f"train.restore_checkpoint={ckpt}"], device,
        expect_from=40960)
    resumed = checkpoint.restore(checkpoint.latest_checkpoint(
        os.path.join(run2, "state")), device="cpu")
    if (rep["resume"]["last_step"], resumed.env_steps,
            resumed.optimizer_state["step"]) != (81920, 81920, 2 * updates):
        raise AssertionError(
            f"resumed run: last step {rep['resume']['last_step']}, "
            f"checkpoint {resumed.env_steps}, Adam step "
            f"{resumed.optimizer_state['step']} (from {updates})")
    finished = compat.policy_from_numpy(os.path.join(run2, "finished.npz"),
                                        device=device)
    if finished.encoder.proj_0.out_features != 256:
        raise AssertionError("finished params: unexpected widths")

    drawn = []
    extra_info = RodentMultiClipTracking._extra_reset_info

    def record_draws(self, *a, **kw):
        out = extra_info(self, *a, **kw)
        drawn.append(out["clip_id"].cpu())
        return out

    RodentMultiClipTracking._extra_reset_info = record_draws
    try:
        rep["multiclip"], c3, _, last = run_cli(
            "multiclip", ["env.name=rodent_multiclip",
                          "env.env_args.clip_length=50",
                          "train.adaptive_clip_weights=True"], device)
    finally:
        RodentMultiClipTracking._extra_reset_info = extra_info
    w = [last[f"training/clip_weight_{c}"] for c in range(5)]
    counts = np.bincount(torch.cat(drawn).numpy(), minlength=5)
    if abs(sum(w) - 1) > 1e-5 or len(counts) != 5 or counts.min() < 1:
        raise AssertionError(f"multi-clip: weights {w}, draws {counts}")
    rep["multiclip"].update(clip_weights=w, clip_draws=counts.tolist())
    rep["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"cli": rep}), flush=True)
    return rep, (c1, c2, c3)


HUMANOID_PRESS = 0.3   # at qpos0 the humanoid's feet are 0.21 m up
# Kernel B on humanoid contact states is held by check_cg_reruns, not by
# check_cg's rule, which no float32 evaluation meets there: with the
# model's 6 CG iterations and 6 line-search rounds, the plain solve re-run
# in float32 with its inputs moved by one rounding lands beyond 1e-3 of
# both its float32 and float64 results on about 2% of these states (the
# counts are printed in the "kernel_b_humanoid" line), near switches of
# the line search's active set.
CONFIG_NETS = dict(intention_latent_size=64, encoder_layer_sizes=(256, 128),
                   decoder_layer_sizes=(128, 256),
                   value_hidden_layer_sizes=(1024, 1024))  # train_config.yaml


def intention_policy(env):
    """make_policy for ``unroll``: a freshly initialised intention policy
    at the config's widths (the same weights every call)."""
    from vnl_tpu_torch import models

    def make(state):
        net = models.make_intention_ppo_networks(
            state.info["traj"].shape[-1], state.obs.shape[-1],
            env.action_size, generator=torch.Generator().manual_seed(SEED),
            device="cuda", **CONFIG_NETS)
        return models.make_inference_fn(net)(deterministic=False)

    return make


def env_rollout(env, device, need, sizes):
    """``env`` wrapped for training, reset for BATCH envs and driven for
    UNROLL control steps by a freshly initialised intention policy at the
    config's widths, sampling from a seeded generator, replayed as the
    control-step graph; returns (launch counts of reset and unroll,
    report).  Requires every kernel in ``need`` ({name: least launches})
    and finite qpos, qvel, reward and observations of the expected (obs,
    traj) ``sizes``."""
    from vnl_tpu_torch.envs import wrap_for_training
    wenv = wrap_for_training(env, episode_length=150)
    run = unroll(wenv, intention_policy(env), graphed=True)
    counts, state, rollout = run["counts"], run["state"], run["rollout"]
    d = state.pipeline_state
    if not all(bool(torch.isfinite(x).all()) for x in
               (d.qpos, d.qvel, rollout.reward, rollout.observation)):
        raise AssertionError(f"{type(env).__name__}: non-finite qpos, qvel, "
                             "reward or obs")
    if (state.obs.shape[-1], state.info["traj"].shape[-1]) != sizes:
        raise AssertionError(f"{type(env).__name__}: obs, traj "
                             f"{state.obs.shape}, {state.info['traj'].shape}")
    for k, least in need.items():
        if counts.get(k, 0) < least:
            raise AssertionError(f"{type(env).__name__}: kernel {k} launched "
                                 f"{counts.get(k, 0)} times, expected >= "
                                 f"{least}")
    return counts, dict(
        reset_s=run["reset_s"], unroll_s=run["unroll_s"],
        env_steps_per_s=BATCH * UNROLL / run["unroll_s"],
        ms_per_control_step=1e3 * run["unroll_s"] / UNROLL,
        mean_reward=float(rollout.reward.mean()),
        done_share=float(rollout.discount.eq(0).float().mean()),
        root_z_mean=float(d.qpos[:, 2].mean()), launches=counts,
        graph=run["graph"])


def add_counts(*counts):
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def print_split(scene, m, trees):
    """One line: kernel_bench.stage_split of the kernels ``scene`` runs,
    at its shapes, and the times of both trees if compare_kernels took
    them (``trees``)."""
    from vnl_tpu_torch.kernel_bench import SCENE_PRESS, stage_split
    kernels = ("position", "cg") if scene == "humanoid" else \
        ("position", "sweep")
    split = stage_split(m, BATCH, press=SCENE_PRESS[scene], kernels=kernels)
    if trees:
        split["trees"] = {k: v for k, v in trees.items()
                          if k.endswith(f"_{scene}_ms")}
    print(json.dumps({f"stage_split_{scene}": split}), flush=True)


def phase_humanoid(device, trees=None):
    """Phase 8; returns (kernel rows, launch counts of its paths, report,
    errors).  ``trees``: compare_kernels' times of this and an earlier
    tree, if taken."""
    import glob
    from vnl_tpu_torch import compat
    from vnl_tpu_torch.envs import HumanoidStanding, HumanoidTracking
    t_phase = time.perf_counter()
    rep = {}
    m, rep["compile_s"] = check_scene_compile(
        compat.DM_HUMANOID_XML,
        {"solver": "cg", "iterations": 6, "ls_iterations": 6}, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    row_a, errs_a = phase_kernel_a(m, gen, "position_humanoid", ())
    row_b, errs_b = phase_kernel_b(m, gen, "cg_humanoid", (),
                                   press=HUMANOID_PRESS, reruns=True)
    if row_a["shape"]["instantiation"] != "position_warp_kernel<32,2>" or \
            row_b["shape"]["instantiation"] != "cg_wide_kernel<3,1>":
        raise AssertionError(f"kernels A, B on the humanoid: "
                             f"{row_a['shape']}, {row_b['shape']}")
    row_d, errs_d = phase_kernel_d(m, gen, "constraints_humanoid",
                                   press=HUMANOID_PRESS)
    print_split("humanoid", m, trees)
    print(json.dumps({"kernel_b_humanoid": dict(
        row_b["shape"], active_contacts=errs_b["active_contacts"],
        **{k: errs_b[k] for k in ("far_envs", "off_envs", "budget_far",
                                  "budget_off", "rerun_far_off")},
        ms=row_b["ms"], plain_ms=row_b["plain_ms"])}), flush=True)
    need = {"position": UNROLL * 5, "cg": UNROLL * 5,
            "constraints": UNROLL * 5}
    c_track, rep["tracking"] = env_rollout(
        HumanoidTracking(device=device), device, need, (55, 630))
    c_stand, rep["standing"] = env_rollout(
        HumanoidStanding(device=device), device, need, (336, 336))
    from vnl_tpu_torch.training import checkpoint
    rep["cli"], c_cli, run, _ = run_cli(
        "humanoid", ["train.num_timesteps=20480"], device,
        env_args=[f"env_config={ROOT}/vnl_tpu_torch/configs/"
                  "humanoid_config.yaml"])
    ckpt = checkpoint.latest_checkpoint(os.path.join(run, "state"))
    finished = compat.policy_from_numpy(os.path.join(run, "finished.npz"),
                                        device=device)
    if not (ckpt or "").endswith("/20480.npz") or \
            finished.encoder.proj_0.in_features != 630 or \
            not glob.glob(os.path.join(run, "20480.npz")):
        raise AssertionError(f"humanoid command line: checkpoint {ckpt}, "
                             "params")
    rep["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"humanoid": rep}), flush=True)
    return ([row_a, row_b, row_d], add_counts(c_track, c_stand, c_cli),
            rep, {"position_humanoid": errs_a, "cg_humanoid": errs_b,
                  "constraints_humanoid": errs_d})


def phase_cmu(device):
    """Phase 17, the CMU humanoid: the committed scene compiled onto the
    card, every field equal to the host's compile; HumanoidTracking on it
    (the cell cmu_train's env), wrapped for training, reset for BATCH envs
    and driven UNROLL control steps (graphed, as in 4), kernels A, B on
    its widest route, D and E at least once a substep.  Returns (launch
    counts, report)."""
    from vnl_tpu_torch import compat
    from vnl_tpu_torch.envs import HumanoidTracking
    t_phase = time.perf_counter()
    rep = {}
    _, rep["compile_s"] = check_scene_compile(
        compat.CMU_HUMANOID_XML,
        {"solver": "cg", "iterations": 6, "ls_iterations": 6}, device)
    need = {k: UNROLL * 5 for k in ("position", "cg", "cg_widest",
                                    "constraints", "collision")}
    counts, rep["tracking"] = env_rollout(
        HumanoidTracking(mjcf_path=compat.CMU_HUMANOID_XML, device=device),
        device, need, (125, 1315))
    rep["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"cmu": rep}), flush=True)
    return counts, rep


def phase_ant(device, trees=None):
    """Phase 9; returns (kernel rows, launch counts of its paths, report,
    errors).  ``trees`` as for phase_humanoid."""
    from vnl_tpu_torch import bench, compat, models
    from vnl_tpu_torch.envs import AntTracking
    from vnl_tpu_torch.kernel_bench import QUEUED, newton_hessians, time_ms
    from vnl_tpu_torch.training import train
    t_phase = time.perf_counter()
    rep = {}
    m, rep["compile_s"] = check_scene_compile(
        compat.GYM_ANT_XML,
        {"solver": "newton", "iterations": 1, "ls_iterations": 4}, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    row_a, errs_a = phase_kernel_a(m, gen, "position_ant", ())
    if row_a["shape"]["instantiation"] != "position_warp_kernel<16,2>":
        raise AssertionError(f"kernel A on the ant: {row_a['shape']}")
    print_split("ant", m, trees)
    # kernel C on the Hessians of the first Newton iteration
    H, active = newton_hessians(m, BATCH, gen, press=0.3)
    errs_c = {"active_contacts": active}
    check_sweep("ant_newton", H, errs_c)
    route = sweep.route(m.nv)
    res = sweep_route_report(m.nv, "warp")
    ms = time_ms(lambda: sweep._launch(H), queued=QUEUED)
    plain_ms = time_ms(lambda: sweep.inv_spd_sweep_plain(H), reps=5)
    library_ms = time_ms(lambda: torch.linalg.inv(H), reps=10)
    b_ms, b_by = bound_ms(2 * BATCH * m.nv ** 2 * 4, BATCH * 2 * m.nv ** 3)
    row_c = dict(name="sweep_ant_newton", kernel="sweep", route="cuda",
                 shape=dict(batch=BATCH, n=m.nv, tile=list(route.tile),
                            instantiation="sweep_warp_kernel<{}>".format(
                                route.tile[0])),
                 source="vnl_tpu_torch/csrc/sweep.cu",
                 replaces="vnl_tpu/ops/pallas_linalg.py:49",
                 max_abs_err=errs_c["ant_newton"], ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                 regs=res["regs"], smem_bytes=res["smem_bytes"],
                 blocks_per_sm=res["blocks_per_sm"],
                 local_bytes=res["local_bytes"],
                 spill_bytes=res["spill_bytes"], kernel_route=route.kind,
                 # compare_kernels' times of both trees, in turns (--old)
                 trees=(trees or {}).get("sweep_ant_ms"))
    print(json.dumps({"kernel_c_ant": {k: row_c[k] for k in (
        "kernel_route", "shape", "regs", "spill_bytes", "ms", "bound_ms",
        "library_ms", "plain_ms", "trees")}}), flush=True)
    env = AntTracking(device=device)
    # every forward pass (4 a physics step, RK4) launches A once and, by
    # its one Newton iteration, C once; B never
    c_roll, rep["rollout"] = env_rollout(
        env, device, {"position": 4 * 5 * UNROLL, "sweep": 4 * 5 * UNROLL},
        (504, 475))
    if c_roll.get("cg", 0) or c_roll["sweep"] < c_roll["position"]:
        raise AssertionError(f"ant rollout launches {c_roll}")
    seen, made = [], {}

    def factory(*a, **kw):
        made["net"] = models.make_intention_ppo_networks(*a, **kw)
        made["init"] = {k: v.clone()
                        for k, v in made["net"].state_dict().items()}
        return made["net"]

    kw = dict(bench.TRAIN_KW, episode_length=EVAL_EPISODE)
    per_step = kw["batch_size"] * kw["unroll_length"] * kw["num_minibatches"]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    train(env, num_timesteps=2 * per_step, num_evals=2,
          progress_fn=lambda step, mt: seen.append((step, mt)),
          network_factory=factory, device=device, **kw)
    torch.cuda.synchronize()
    c_train = dict(launch_counts)
    step, last = seen[-1]
    bad = [k for k, v in last.items() if not np.isfinite(v)]
    now = made["net"].state_dict()
    still = [k for k, v in made["init"].items()
             if k.endswith("weight") and torch.equal(v, now[k])]
    widths = (made["net"].policy.encoder.proj_0.out_features,
              made["net"].value.hidden_0.out_features)
    if bad or still or step != 2 * per_step or widths != (1024, 1024) or \
            c_train.get("cg", 0) or c_train.get("sweep", 0) < \
            c_train.get("position", 0) or c_train.get("position", 0) < \
            2 * 4 * 5 * UNROLL:
        raise AssertionError(f"ant training: non-finite {bad}, unmoved "
                             f"{still}, steps {step}, widths {widths}, "
                             f"launches {c_train}")
    rep["training"] = dict(
        training_steps=2, env_steps=step, wall_s=time.perf_counter() - t0,
        training_env_steps_per_s=last["training/sps"],
        rollout_s_per_training_step=last["training/rollout_s_per_step"],
        sgd_s_per_training_step=last["training/sgd_s_per_step"],
        eval_s=last["eval/epoch_eval_time"], launches=c_train)
    rep["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"ant": rep}), flush=True)
    return ([row_a, row_c], add_counts(c_roll, c_train), rep,
            {"position_ant": errs_a, "sweep_ant_newton": errs_c})


PIXEL_SHARE = 0.005   # frames: at most this share > 1 level apart


def frames_off_share(got, want) -> float:
    """Share of the pixels of two uint8 frame stacks more than one level
    apart in any channel (tests/test_torch_render.py's tolerance)."""
    off = (got.int() - want.int()).abs().amax(-1) > 1
    return float(off.float().mean())


def phase_render(device):
    """Phase 10; returns its report."""
    from vnl_tpu_torch import compat
    from vnl_tpu_torch.kernel_bench import random_states
    from vnl_tpu_torch.render import make_egocentric_camera
    from vnl_tpu_torch.render.software import overlay_frames
    t_phase = time.perf_counter()
    rep = {}
    # every render job of the command lines: a video (a .gif written by
    # utils/images.py where imageio is missing)
    jobs = []
    for cb in CALLBACKS:
        res = cb.render_result(timeout=600)
        jobs.append(res)
        ok = res is not None and os.path.exists(res)
        if not ok:
            raise AssertionError(f"eval-callback render job: {res!r}")
    rep["render_jobs"] = jobs
    cb = CALLBACKS[0]                 # phase 7's first run, the twin
    traj = cb.last_traj
    qa, qr = cb.overlay_inputs(traj["qpos"], traj["start_frame"],
                               traj["clip_id"])
    model = cb._env.sys
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # on the callback's render thread and stream, as its jobs run
    frames = cb.in_render_thread(
        lambda: overlay_frames(model, qa, qr, device=device)).result()
    t0 = time.perf_counter()
    frames = cb.in_render_thread(
        lambda: overlay_frames(model, qa, qr, device=device)).result()
    card_s = time.perf_counter() - t0
    rep["overlay_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    t0 = time.perf_counter()
    cpu = overlay_frames(model, qa, qr, device="cpu")
    cpu_s = time.perf_counter() - t0
    n = frames.shape[0]
    if frames.shape != (n, 240, 320, 3) or n != len(qa) or n < 2:
        raise AssertionError(f"overlay frames {tuple(frames.shape)}")
    share = frames_off_share(frames.cpu(), cpu)
    if share > PIXEL_SHARE:
        raise AssertionError(f"overlay: {share:.4%} of the pixels differ "
                             "from the CPU's frames")
    if float((frames != 255).any(-1).float().mean()) < 0.5:
        raise AssertionError("overlay frames are blank")
    rep["overlay"] = dict(frames=n, width=320, height=240,
                          off_share=share, ms_per_frame=1e3 * card_s / n,
                          cpu_ms_per_frame=1e3 * cpu_s / n)

    # the egocentric camera on 1024 twin states
    m = compat.model_from_numpy(compat.TWIN_MODEL, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    qpos = random_states(m, BATCH, gen)
    d = kinematics.kinematics(m, forward.make_data(m, BATCH, qpos))
    camera = make_egocentric_camera(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    img = camera(d)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        img = camera(d)
    torch.cuda.synchronize()
    cam_ms = 1e3 * (time.perf_counter() - t0) / reps
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    m_cpu = compat.model_from_numpy(compat.TWIN_MODEL, device="cpu")
    d8 = d.replace(**{f: getattr(d, f)[:8].cpu() for f in (
        "xpos", "xmat", "geom_xpos", "geom_xmat")})
    want = make_egocentric_camera(m_cpu)(d8)
    err = (img[:8].cpu() - want).abs()
    within = float((err <= 1e-4).all(-1).float().mean())
    if img.shape != (BATCH, 64, 64, 3) or within < 0.995 or \
            not bool(torch.isfinite(img).all()):
        raise AssertionError(f"camera: {tuple(img.shape)}, {within:.4%} of "
                             "the pixels within 1e-4 of the CPU's")
    rep["camera"] = dict(envs=BATCH, width=64, height=64,
                         geoms=m.ngeom,
                         ms_per_call=cam_ms, peak_mb=peak,
                         within_1e4=within, max_abs_err=float(err.max()),
                         lit_share=float((img > 0.15).float().mean()))
    rep["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"render": rep}), flush=True)
    return rep


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_data_parallel(device):
    """Phase 11; returns (launch counts of its runs, report)."""
    import subprocess
    import torch.distributed as dist
    from vnl_tpu_torch import bench, models
    from vnl_tpu_torch.envs import make_twin_env
    from vnl_tpu_torch.parallel import mesh
    from vnl_tpu_torch.training import gradients, train
    t_phase = time.perf_counter()
    kw = dict(bench.TRAIN_KW, episode_length=EVAL_EPISODE)
    per_step = kw["batch_size"] * kw["unroll_length"] * kw["num_minibatches"]
    updates = kw["num_minibatches"] * kw["num_updates_per_batch"]

    def one_step(**extra):
        seen, made = [], {}

        def factory(*a, **fkw):
            made["net"] = models.make_intention_ppo_networks(*a, **fkw)
            return made["net"]

        torch.cuda.synchronize()
        reset_launch_counts()
        mesh.reset_collective_counts()
        _, (norm, policy), _ = train(
            make_twin_env(device=device), num_timesteps=per_step,
            num_evals=1, network_factory=factory, device=device,
            progress_fn=lambda step, mt: seen.append(mt), **kw, **extra)
        torch.cuda.synchronize()
        params = dict({f"policy.{k}": v for k, v in policy.items()},
                      **{f"normalizer.{k}": getattr(norm, k) for k in (
                          "count", "mean", "summed_variance", "std")})
        return (params, seen[-1], dict(launch_counts),
                dict(mesh.collective_counts), made["net"])

    plain, m_plain, c_plain, _, _ = one_step()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        grouped, m_dp, c_dp, coll, net = one_step(num_devices=1)
        # the all-reduce of one SGD update's gradients, on its own
        for p in net.parameters():
            p.grad = torch.ones_like(p)
        params = list(net.parameters())
        for _ in range(3):
            gradients.all_reduce_gradients(params)
        torch.cuda.synchronize()
        reps = 20
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                gradients.all_reduce_gradients(params)
            torch.cuda.synchronize()
        # device time of every kernel and copy of the all-reduce step (the
        # concatenation, NCCL's work, the division, the copy back)
        dev_us = {e.key: getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0)
                  for e in prof.key_averages()}
        dev_us = {k: v for k, v in dev_us.items() if v > 0}
        t0 = time.perf_counter()
        for _ in range(reps):
            gradients.all_reduce_gradients(params)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
        nparam = sum(p.numel() for p in params)
    finally:
        dist.destroy_process_group()
    def bits(t):
        return t.dtype, tuple(t.shape), t.cpu().numpy().tobytes()

    diff = [k for k in plain if bits(plain[k]) != bits(grouped[k])]
    if diff or sorted(plain) != sorted(grouped):
        raise AssertionError(f"one-rank NCCL training differs from the run "
                             f"without a group in {diff}")
    want = {"grad_all_reduce": updates, "normalizer_all_reduce": 2,
            "metrics_all_reduce": 1}
    if any(coll.get(k, 0) != v for k, v in want.items()) or \
            coll.get("all_gather", 0) < 2 or coll.get("all_reduce", 0) < 1:
        raise AssertionError(f"collectives of the one-rank run: {coll}")
    for tag, c in (("plain", c_plain), ("one-rank", c_dp)):
        if c.get("position", 0) < 100 or c.get("cg", 0) < 100 or \
                c.get("sweep", 0):
            raise AssertionError(f"{tag} run launches {c}")
    rep = dict(
        env_steps_per_s=m_plain["training/sps"],
        env_steps_per_s_one_rank_nccl=m_dp["training/sps"],
        sgd_s_per_training_step=m_plain["training/sgd_s_per_step"],
        sgd_s_per_training_step_one_rank=m_dp["training/sgd_s_per_step"],
        params_equal_bitwise=True, compared=len(plain),
        collectives=coll, sgd_updates=updates,
        all_reduces_per_update=coll["grad_all_reduce"] / updates,
        grad_all_reduce_floats=nparam,
        grad_all_reduce_device_ms=1e-3 * sum(dev_us.values()) / reps,
        grad_all_reduce_nccl_device_ms=1e-3 * sum(
            v for k, v in dev_us.items() if "nccl" in k.lower()) / reps,
        grad_all_reduce_device_ops=sorted(dev_us),
        grad_all_reduce_wall_ms=wall_ms)

    # the command line under torch.distributed.run, one process
    out = os.path.join(CLI_DIR, "torchrun")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes=1",
           "--nproc_per_node=1", "--master_addr=127.0.0.1",
           f"--master_port={free_port()}", "-m", "vnl_tpu_torch.train"] + \
        TWIN_ARGS + [f"train.checkpoint_dir={out}/ck",
                     f"train.log_dir={out}/logs", "train.episode_length=30",
                     "train.num_timesteps=20480", "train.eval_every=20480"]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    rep["torchrun_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"torch.distributed.run: exit {proc.returncode}")
    recs = _records(os.path.join(out, "logs"))
    last = [r for r in recs if "training/sps" in r][-1]
    rep["torchrun_env_steps_per_s"] = last["training/sps"]
    rep["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"data_parallel": rep}), flush=True)
    return add_counts(c_plain, c_dp), rep


SKIN_BONES = ("pelvis", "torso", "skull")


def write_twin_skin(path, m, rings=16, seg=20, seed=0):
    """A synthetic MuJoCo binary skin (.skn) around the twin's spine, built
    as tests/test_torch_render.py write_skn builds one around its scene's
    arm: a closed ellipsoidal hull (rings x seg vertices and two poles,
    jittered from a seed), 3 bones named after the twin's pelvis, torso
    and skull, bound at their qpos0 poses (the port's host FK), weights
    blended by the distance along the spine, 2 texcoords a vertex (skipped
    by the parser).  Returns (vertices, faces)."""
    import struct
    from vnl_tpu_torch.render.software import numpy_fk
    rng = np.random.default_rng(seed)
    verts = [(0.0, 0.0, 1.0)]
    for i in range(1, rings + 1):
        th = np.pi * i / (rings + 1)
        for j in range(seg):
            ph = 2 * np.pi * j / seg
            verts.append((np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                          np.cos(th)))
    verts.append((0.0, 0.0, -1.0))
    verts = np.asarray(verts) * np.array([0.022, 0.025, 0.075])
    verts = verts[:, [2, 1, 0]] + np.array([-0.005, 0.0, 0.07])
    verts += 0.001 * rng.normal(size=verts.shape)
    nv = len(verts)
    faces = [(0, 1 + j, 1 + (j + 1) % seg) for j in range(seg)]
    for i in range(rings - 1):
        a, b = 1 + i * seg, 1 + (i + 1) * seg
        for j in range(seg):
            k = (j + 1) % seg
            faces += [(a + j, b + j, b + k), (a + j, b + k, a + k)]
    last = 1 + (rings - 1) * seg
    faces += [(nv - 1, last + (j + 1) % seg, last + j) for j in range(seg)]
    xpos, xquat, _, _ = numpy_fk(m, m.qpos0.cpu().numpy())
    names = list(m.body_names)
    with open(path, "wb") as f:
        f.write(struct.pack("<4i", nv, nv, len(faces), len(SKIN_BONES)))
        f.write(np.asarray(verts, "<f4").tobytes())
        f.write(rng.uniform(size=(nv, 2)).astype("<f4").tobytes())
        f.write(np.asarray(faces, "<i4").tobytes())
        for name in SKIN_BONES:
            bid = names.index(name)
            w = np.exp(-((verts[:, 0] - xpos[bid, 0]) / 0.03) ** 2)
            vid = np.nonzero(w > 0.05)[0]
            f.write(name.encode().ljust(40, b"\0"))
            f.write(struct.pack("<3f", *xpos[bid]))
            f.write(struct.pack("<4f", *xquat[bid]))
            f.write(struct.pack("<i", len(vid)))
            f.write(vid.astype("<i4").tobytes())
            f.write(w[vid].astype("<f4").tobytes())
    return nv, len(faces)


EVAL_ENVS, CLIP_HORIZON = 16, 245     # the twin clip: 250 - 5 frames
SKIN_FRAMES = 8


def phase_checkpoint_tools(device):
    """Phase 12; returns (report, launch counts of its runs)."""
    import glob
    from vnl_tpu_torch import compat, eval_checkpoint, render_checkpoint
    from vnl_tpu_torch.envs import RodentMultiClipTracking
    from vnl_tpu_torch.examples import train_multiclip
    from vnl_tpu_torch.render.software import overlay_frames
    from vnl_tpu_torch.utils import apply_overrides, load_config
    t_phase = time.perf_counter()
    rep, all_counts = {}, []
    (run,) = glob.glob(os.path.join(CLI_DIR, "train", "ck", "*"))
    steps = max(int(n[:-4]) for n in os.listdir(run)
                if n.endswith(".npz") and n[:-4].isdigit())
    params = os.path.join(run, f"{steps}.npz")
    state = os.path.join(run, "state", f"{steps}.npz")
    cfg = apply_overrides(load_config(eval_checkpoint.TWIN_CONFIG), [
        f"env.clip_path={compat.TWIN_CLIP}",
        f"env.env_args.mjcf_path={TWIN_XML}"])

    # 1. the deterministic evaluation from the params file and the state
    results = {}
    for tag, path in (("params", params), ("state", state)):
        torch.cuda.synchronize()
        reset_launch_counts()
        res = eval_checkpoint.evaluate(path, EVAL_ENVS, cfg, device)
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        all_counts.append(counts)
        rec = eval_checkpoint.report(res, os.path.relpath(path, ROOT),
                                     device)
        print(json.dumps({"eval_checkpoint": rec}), flush=True)
        rew, lengths = res["rewards"], res["lengths"]
        if res["horizon"] != CLIP_HORIZON or rew.shape != (EVAL_ENVS,) or \
                not np.isfinite(rew).all() or lengths.min() < 1 or \
                lengths.max() > CLIP_HORIZON:
            raise AssertionError(f"eval_checkpoint {tag}: horizon "
                                 f"{res['horizon']}, rewards {rew}, "
                                 f"lengths {lengths}")
        need = 5 * CLIP_HORIZON
        if counts.get("position", 0) < need or counts.get("cg", 0) < need \
                or counts.get("sweep", 0):
            raise AssertionError(f"eval_checkpoint {tag}: launches {counts}"
                                 f", A and B need {need} each, C none")
        results[tag] = res
        rep[f"eval_{tag}"] = dict(seconds=res["seconds"],
                                  capture_s=res["capture_s"],
                                  load_s=res["load_s"], launches=counts,
                                  reward_mean=rec["reward_mean"],
                                  length_mean=rec["length_mean"])
    # the params file again, eagerly: the seconds both ways, the same bits
    torch.cuda.synchronize()
    reset_launch_counts()
    results["eager"] = eval_checkpoint.evaluate(params, EVAL_ENVS, cfg,
                                                device, cuda_graphs=False)
    torch.cuda.synchronize()
    if dict(launch_counts) != all_counts[0]:
        raise AssertionError(f"eval_checkpoint eager: launches "
                             f"{dict(launch_counts)}, graphed {all_counts[0]}")
    rep["eval_params"]["eager_seconds"] = results["eager"]["seconds"]
    for key in ("rewards", "lengths"):
        a = results["params"][key]
        for other in ("state", "eager"):
            b = results[other][key]
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"eval_checkpoint: {key} of the params "
                                     f"file and of the {other} run differ")
    if results["state"]["env_steps"] != steps:
        raise AssertionError(f"state file at {results['state']['env_steps']}")

    # 2. render_checkpoint with a synthetic skin around the twin
    m_cpu = compat.model_from_numpy(compat.TWIN_MODEL, device="cpu")
    skin = os.path.join(CLI_DIR, "twin_hull.skn")
    rep["skin_verts"], rep["skin_faces"] = write_twin_skin(skin, m_cpu)
    out_prefix = os.path.join(CLI_DIR, "render_checkpoint", "rollout")
    os.makedirs(os.path.dirname(out_prefix), exist_ok=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = render_checkpoint.render(params, out_prefix, cfg, device,
                                   skin=skin)
    torch.cuda.synchronize()
    all_counts.append(dict(launch_counts))
    n = len(out["traj"]["reward"])
    if not (os.path.getsize(out["diag"]) > 0 and
            os.path.getsize(out["video"]) > 0 and
            out["video"].endswith((".mp4", ".gif"))) or \
            tuple(out["frames"].shape) != (n, 240, 320, 3):
        raise AssertionError(f"render_checkpoint wrote {out['diag']}, "
                             f"{out['video']}, frames "
                             f"{tuple(out['frames'].shape)}")
    rep["render"] = dict(steps=n, video=os.path.basename(out["video"]),
                         rollout_s=out["rollout_s"],
                         capture_s=out["capture_s"],
                         render_s=out["render_s"],
                         ms_per_frame=1e3 * out["render_s"] / n)
    # the first skinned overlay frames of phase 7's first eval-callback
    # episode (30 steps) on the card, timed after a warm-up, and on the CPU
    cb = CALLBACKS[0]
    traj = cb.last_traj
    qa, qr = cb.overlay_inputs(traj["qpos"], traj["start_frame"],
                               traj["clip_id"])
    qa, qr = qa[:SKIN_FRAMES], qr[:SKIN_FRAMES]
    model = cb._env.sys
    overlay_frames(model, qa, qr, skin=skin, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    frames = overlay_frames(model, qa, qr, skin=skin, device=device)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    t0 = time.perf_counter()
    cpu = overlay_frames(m_cpu, qa, qr, skin=skin, device="cpu")
    cpu_s = time.perf_counter() - t0
    plain = overlay_frames(m_cpu, qa, qr, skin=None, device="cpu")
    share = frames_off_share(frames.cpu(), cpu)
    if frames.shape != (SKIN_FRAMES, 240, 320, 3) or share > PIXEL_SHARE:
        raise AssertionError(f"skinned overlay {tuple(frames.shape)}: "
                             f"{share:.4%} of the pixels differ from the "
                             "CPU's frames")
    hide = float((cpu != plain).any(-1).float().mean())
    if hide < 0.002:
        raise AssertionError("the skin does not show in the overlay")
    rep["skinned_overlay"] = dict(
        frames=SKIN_FRAMES, off_share=share, skin_pixel_share=hide,
        ms_per_frame=1e3 * card_s / SKIN_FRAMES,
        cpu_ms_per_frame=1e3 * cpu_s / SKIN_FRAMES, peak_mb=peak)

    # 3. the multi-clip example at its own sizes, one training step
    drawn = []
    extra_info = RodentMultiClipTracking._extra_reset_info

    def record_draws(self, *a, **kw):
        got = extra_info(self, *a, **kw)
        drawn.append(got["clip_id"].cpu())
        return got

    kw = train_multiclip.TRAIN_KW
    per_step = kw["batch_size"] * kw["num_minibatches"] * kw["unroll_length"]
    RodentMultiClipTracking._extra_reset_info = record_draws
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        _, _, metrics = train_multiclip.main(per_step, device)
    finally:
        RodentMultiClipTracking._extra_reset_info = extra_info
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    all_counts.append(counts)
    losses = {k: v for k, v in metrics.items() if k.startswith("training/")
              and "loss" in k}
    draws = np.bincount(torch.cat(drawn).numpy(), minlength=2)
    if not losses or not all(np.isfinite(v) for v in losses.values()) or \
            len(draws) != 2 or draws.min() < 1:
        raise AssertionError(f"train_multiclip: losses {losses}, clip "
                             f"draws {draws}")
    # control steps: the training step's unrolls, two 50-step evaluations
    control = per_step // kw["num_envs"] + 2 * kw["episode_length"]
    check_cli_launches("train_multiclip", counts, 5 * control)
    rep["train_multiclip"] = dict(
        seconds=time.perf_counter() - t0, env_steps=per_step,
        env_steps_per_s=metrics["training/sps"],
        total_loss=losses["training/total_loss"],
        clip_draws=draws.tolist(), launches=counts)
    rep["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"checkpoint_tools": rep}), flush=True)
    return rep, add_counts(*all_counts)


STEPPING_SAMPLES = 3


def phase_stepping(device):
    """Phase 13: the stepping bench at BATCH envs; returns (launch counts,
    its line)."""
    from vnl_tpu_torch import bench
    torch.cuda.synchronize()
    reset_launch_counts()
    out = bench.run_stepping(device, batch=BATCH, n_steps=UNROLL,
                             samples=STEPPING_SAMPLES, warmup=2)
    counts = dict(launch_counts)
    d = out.pop("state")
    finite = all(bool(torch.isfinite(x).all())
                 for x in (d.pipeline_state.qpos, d.pipeline_state.qvel,
                           d.reward))
    few = [c for c in out["launches_per_sample"]
           if c["position"] < 100 or c["cg"] < 100]
    if not finite or few or out["samples"] != STEPPING_SAMPLES or \
            out["envs"] != BATCH:
        raise AssertionError(f"stepping bench: finite {finite}, launches "
                             f"{out['launches_per_sample']}, {out['envs']} "
                             "envs")
    out["name_and_power_limit"] = bench.gpu_name_and_power_limit()
    print(json.dumps({"stepping": out}), flush=True)
    return counts, out


def phase_numerics(device, out_dir=""):
    """Phase 14: vnl_tpu_torch.check_numerics at BATCH envs (every rollout
    golden, fused and unfused; the three forward goldens, fused and
    unfused; the kernels' launches in every part), then kernel C on the
    humanoid's unfused pair (2, BATCH, 27, 27), the shape only this phase's
    humanoid parts run.  Returns (launch counts by scene, C's humanoid row,
    report)."""
    from vnl_tpu_torch import check_numerics
    from vnl_tpu_torch.kernel_bench import (QUEUED, random_states, time_ms,
                                            twin_pair)
    t_phase = time.perf_counter()
    rep = check_numerics.run(device, batch=BATCH)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "check_numerics.json"), "w") as f:
            json.dump(rep, f, indent=1)
    if not rep["ok"]:
        raise AssertionError(f"check_numerics: {rep['failures']}")
    counts = {scene: add_counts(*(p["launches"] for p in rep["parts"]
                                  if p["scene"] == scene))
              for scene in check_numerics.FORWARDS}
    # C on the humanoid's pair [qM, qM + h diag(B)], as its unfused stage
    # inverts it on a control step's first substep
    m = check_numerics.make_env("humanoid", device, False).sys
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    pair = twin_pair(m, random_states(m, BATCH, gen))
    errs = {}
    check_sweep("humanoid_pair", pair, errs)
    route, res = sweep.route(m.nv), sweep_route_report(m.nv, "warp")
    flat = pair.reshape(-1, m.nv, m.nv)
    b_ms, b_by = bound_ms(2 * flat.shape[0] * m.nv ** 2 * 4,
                          flat.shape[0] * 2 * m.nv ** 3)
    row = dict(name="sweep_humanoid", kernel="sweep", route="cuda",
               shape=dict(batch=list(pair.shape[:2]), n=m.nv,
                          tile=list(route.tile),
                          instantiation="sweep_warp_kernel<{}>".format(
                              route.tile[0])),
               source="vnl_tpu_torch/csrc/sweep.cu",
               replaces="vnl_tpu/ops/pallas_linalg.py:49",
               max_abs_err=errs["humanoid_pair"],
               ms=time_ms(lambda: sweep._launch(pair), queued=QUEUED),
               plain_ms=time_ms(lambda: sweep.inv_spd_sweep_plain(pair),
                                reps=5),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=time_ms(lambda: torch.linalg.inv(flat), reps=10),
               regs=res["regs"], smem_bytes=res["smem_bytes"],
               blocks_per_sm=res["blocks_per_sm"],
               local_bytes=res["local_bytes"],
               spill_bytes=res["spill_bytes"], kernel_route=route.kind)
    summary = {
        "rollouts": {name: {stage: {k: r[k] for k in (
            "envs", "early_qpos", "tol_qpos", "max_reward", "early_actions",
            "full_horizon_qpos", "bitwise_copies", "first_parted_step",
            "copies")}
            for stage, r in stages.items()}
            for name, stages in rep["rollouts"].items()},
        "forward": {scene: {stage: {k: r[k] for k in (
            "contacts", "qacc", "tol_qacc", "qfrc_constraint")}
            for stage, r in stages.items()}
            for scene, stages in rep["forward"].items()},
        "parts_s": {f"{p['kind']} {p['scene']} {p['stage']}": p["s"]
                    for p in rep["parts"]},
        "check_s": rep["s"], "launches": counts,
        "kernel_c_humanoid": {k: row[k] for k in (
            "shape", "ms", "bound_ms", "library_ms", "plain_ms",
            "max_abs_err", "regs", "spill_bytes")},
        "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"numerics": summary}), flush=True)
    return counts, row, summary


def differing(a, b) -> list:
    """The paths of two nests' tensors that are not equal bit for bit
    (or whose structures differ)."""
    from vnl_tpu_torch.utils import graphs
    la, lb = list(graphs.named_leaves(a)), list(graphs.named_leaves(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return ["<structure>"]

    def bits(t):
        return t.reshape(-1).contiguous().view(torch.uint8)

    return [p for (p, x), (_, y) in zip(la, lb)
            if x.dtype != y.dtype or x.shape != y.shape or
            not torch.equal(bits(x), bits(y))]


def rollout_pair(tag, env, make_policy):
    """``unroll`` eagerly and graphed from the same seed: every tensor of
    the final state and the rollout (qpos, qvel, reward, action, ...)
    equal bit for bit, and the launch counts equal; the kernels A, B and
    C that a profiled replay ran on the device equal the launches its
    capture counts a replay.  Returns (the graphed run's launch counts,
    report)."""
    from vnl_tpu_torch.utils import graphs
    eager = unroll(env, make_policy, graphed=False)
    graphed = unroll(env, make_policy, graphed=True, again=True)
    diff = differing((eager["state"], eager["rollout"]),
                     (graphed["state"], graphed["rollout"]))
    if diff or eager["counts"] != graphed["counts"]:
        raise AssertionError(f"{tag}: graphed differs from eager in "
                             f"{diff[:8]} ({len(diff)}), launches "
                             f"{eager['counts']} / {graphed['counts']}")
    per_replay = {counter: graphed["graph"]["launches_per_replay"].get(
        counter, 0) for counter, _ in COUNTED_GROUPS}
    if graphed["profiled"] != per_replay or not any(per_replay.values()):
        raise AssertionError(f"{tag}: a profiled control-step replay ran "
                             f"{graphed['profiled']} of kernels A to F; "
                             f"its capture counts {per_replay}")
    return graphed["counts"], dict(
        compared=len(list(graphs.named_leaves(
            (eager["state"], eager["rollout"])))),
        launches=graphed["counts"],
        profiled_launches_per_replay=graphed["profiled"],
        eager_ms_per_control_step=1e3 * eager["unroll_s"] / UNROLL,
        graphed_first_unroll_ms_per_control_step=(
            1e3 * graphed["unroll_s"] / UNROLL),
        graphed_ms_per_control_step=1e3 * graphed["again_s"] / UNROLL,
        graph=graphed["graph"])


def train_pair(device):
    """train(...) at the bench's hyperparameters (fused stage, episode
    EVAL_EPISODE) for one interval of two training steps, an evaluation
    before and after it, eagerly and with CUDA graphs: every final
    parameter and buffer of the networks (the normaliser's mean and std
    among them), every loss metric and every evaluation metric equal bit
    for bit (the evaluation graph, captured before the training steps,
    reads the weights they wrote in place), and the launch counts equal.
    Returns (the graphed run's launch counts, report)."""
    from vnl_tpu_torch import bench, models
    from vnl_tpu_torch.envs import make_twin_env
    from vnl_tpu_torch.training import train
    from vnl_tpu_torch.utils import graphs
    kw = dict(bench.TRAIN_KW, episode_length=EVAL_EPISODE)
    per_step = kw["batch_size"] * kw["unroll_length"] * kw["num_minibatches"]
    runs = {}
    for graphed in (False, True):
        made, seen = {}, []

        def factory(*a, **fkw):
            made["net"] = models.make_intention_ppo_networks(*a, **fkw)
            return made["net"]

        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        train(make_twin_env(device=device), num_timesteps=2 * per_step,
              num_evals=2, network_factory=factory, device=device,
              cuda_graphs=graphed,
              progress_fn=lambda step, m: seen.append(m), **kw)
        torch.cuda.synchronize()
        runs[graphed] = dict(
            params=made["net"].state_dict(), metrics=seen[-1],
            evals=[eval_metrics(m) for m in seen],
            counts=dict(launch_counts), s=time.perf_counter() - t0)
    eager, graphed = runs[False], runs[True]
    if len(eager["evals"]) != 2:
        raise AssertionError(f"training: {len(eager['evals'])} evaluations")
    diff = differing(eager["params"], graphed["params"])
    diff += differing(eager["evals"], graphed["evals"])
    losses = [k for k in eager["metrics"] if k.startswith("training/")
              and not k.endswith(("sps", "walltime", "_s_per_step"))]
    diff += [k for k in losses
             if eager["metrics"][k] != graphed["metrics"][k]]
    if diff or eager["counts"] != graphed["counts"]:
        raise AssertionError(f"training: graphed differs from eager in "
                             f"{diff[:8]} ({len(diff)}), launches "
                             f"{eager['counts']} / {graphed['counts']}")
    return graphed["counts"], dict(
        compared=len(eager["params"]) + len(losses) +
        len(list(graphs.named_leaves(eager["evals"]))),
        launches=graphed["counts"],
        **{f"{tag}_{k}": runs[g]["metrics"][f"training/{k}"]
           for tag, g in (("eager", False), ("graphed", True))
           for k in ("sps", "rollout_s_per_step", "sgd_s_per_step")},
        **{f"{tag}_run_s": runs[g]["s"]
           for tag, g in (("eager", False), ("graphed", True))})


TIMES = ("eval/walltime", "eval/epoch_eval_time", "eval/sps")


def eval_metrics(metrics) -> dict:
    """An evaluation's metrics as tensors, its clock readings left out."""
    return {k: torch.as_tensor(np.asarray(v)) for k, v in metrics.items()
            if k.startswith("eval/") and k not in TIMES}


def replay_profiled(tag, graph) -> dict:
    """One more replay of an envs.StateGraph traced with torch.profiler:
    the kernels A to F it ran must be the launches its capture counts
    a replay.  Returns them."""
    per_replay = {counter: graph.report["launches_per_replay"].get(
        counter, 0) for counter, _ in COUNTED_GROUPS}
    ran = profiled_launches(lambda: graph(graph.state))
    if ran != per_replay or not any(per_replay.values()):
        raise AssertionError(f"{tag}: a profiled replay ran {ran} of "
                             f"kernels A to F; its capture counts "
                             f"{per_replay}")
    return ran


def graph_pair(tag, run):
    """``run(graphed)`` eagerly and graphed, each from launch counts at 0:
    it returns (its results, the StateGraphs it made, seconds).  The
    results equal bit for bit, the launch counts equal, every graph made
    once (a later call replays it) and a profiled replay of each backs
    the counts.  Returns (the graphed run's launch counts, report)."""
    from vnl_tpu_torch.utils import graphs
    runs = {}
    for graphed in (False, True):
        torch.cuda.synchronize()
        reset_launch_counts()
        out, made, seconds = run(graphed)
        torch.cuda.synchronize()
        runs[graphed] = dict(out=out, made=made, s=seconds,
                             counts=dict(launch_counts))
    eager, graphed = runs[False], runs[True]
    diff = differing(eager["out"], graphed["out"])
    if diff or eager["counts"] != graphed["counts"] or eager["made"] or \
            not graphed["made"]:
        raise AssertionError(f"{tag}: graphed differs from eager in "
                             f"{diff[:8]} ({len(diff)}), launches "
                             f"{eager['counts']} / {graphed['counts']}, "
                             f"graphs {len(graphed['made'])}")
    return graphed["counts"], dict(
        compared=len(list(graphs.named_leaves(eager["out"]))),
        launches=graphed["counts"], eager_s=eager["s"],
        graphed_s=graphed["s"],
        profiled_launches_per_replay=[replay_profiled(tag, g)
                                      for g in graphed["made"]],
        graphs=[g.report for g in graphed["made"]])


def timed_calls(calls):
    """Runs each of ``calls`` between synchronisations; (results, s)."""
    out, seconds = [], []
    for call in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(call())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return out, seconds


def evaluator_pair(device):
    """The twin's fused Evaluator, 128 envs x EVAL_EPISODE steps, the
    keeper's sampling policy: two evaluations, their metrics and final
    states."""
    from vnl_tpu_torch.envs import make_twin_env, wrap_for_training
    from vnl_tpu_torch.training import Evaluator
    from vnl_tpu_torch.utils import graphs

    def run(graphed):
        ev = Evaluator(
            wrap_for_training(make_twin_env(device=device),
                              episode_length=EVAL_EPISODE),
            keeper_policy(None), num_eval_envs=EVAL_BATCH,
            episode_length=EVAL_EPISODE, action_repeat=1,
            generator=torch.Generator(device=device).manual_seed(SEED + 15),
            cuda_graphs=graphed)

        def once():
            m = ev.run_evaluation({})
            return eval_metrics(m), graphs.clone(ev.last_state)

        out, seconds = timed_calls([once, once])
        return out, ev.graphs, seconds

    return graph_pair("evaluator", run)


def phase7_params():
    """The params files of phase 7's first run, by env steps."""
    import glob
    (run,) = glob.glob(os.path.join(CLI_DIR, "train", "ck", "*"))
    return [os.path.join(run, f"{n}.npz") for n in sorted(
        int(f[:-4]) for f in os.listdir(run)
        if f.endswith(".npz") and f[:-4].isdigit())]


def twin_eval_cfg():
    """The twin config with phase 7's clip and the twin's MJCF."""
    from vnl_tpu_torch import compat, eval_checkpoint
    from vnl_tpu_torch.utils import apply_overrides, load_config
    return apply_overrides(load_config(eval_checkpoint.TWIN_CONFIG), [
        f"env.clip_path={compat.TWIN_CLIP}",
        f"env.env_args.mjcf_path={TWIN_XML}"])


def eval_checkpoint_pair(device):
    """eval_checkpoint.evaluate on phase 7's last params file, EVAL_ENVS
    envs over the whole clip, with fixed draws (``noise=``: reset noise
    and a latent a step, the graph's static latent): the rewards, the
    lengths and the final state."""
    from vnl_tpu_torch import eval_checkpoint
    from vnl_tpu_torch.utils import graphs
    params, cfg = phase7_params()[-1], twin_eval_cfg()
    width = eval_checkpoint.load_policy(params, device)[0].latent_width
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    noise = {"start_frame": torch.zeros(EVAL_ENVS, dtype=torch.long,
                                        device=device),
             "reset": 1e-3 * torch.randn(EVAL_ENVS, 74, generator=gen,
                                         device=device),
             "latent": [torch.randn(EVAL_ENVS, width, generator=gen,
                                    device=device)
                        for _ in range(CLIP_HORIZON)]}

    def run(graphed):
        (res,), seconds = timed_calls([lambda: eval_checkpoint.evaluate(
            params, EVAL_ENVS, cfg, device, noise=noise,
            cuda_graphs=graphed)])
        ev = res["evaluator"]
        return ((torch.as_tensor(res["rewards"]),
                 torch.as_tensor(res["lengths"]),
                 graphs.clone(ev.last_state)), ev.graphs, seconds)

    return graph_pair("eval_checkpoint_noise", run)


def callback_pair(device):
    """EvalCallback.rollout on the twin's eval env, EVAL_EPISODE steps at
    batch 1, over two calls (phase 7's first and last params files, as
    the command line's callback loads a new policy each call) from one
    generator reseeded with the call's number, each call once to the end
    and once stopping at done: every series."""
    from vnl_tpu_torch.train import build_env
    from vnl_tpu_torch.training import checkpoint as ckpt_lib
    from vnl_tpu_torch.training.eval_callback import EvalCallback
    files = phase7_params()
    env = build_env(twin_eval_cfg(), for_eval=True, device=device)

    def run(graphed):
        cb = EvalCallback(env, "", episode_length=EVAL_EPISODE, plots=False,
                          cuda_graphs=graphed)
        gen = torch.Generator(device=device)
        calls = []
        for call, path in enumerate((files[0], files[-1])):
            policy = ckpt_lib.load_params(path, device=device)
            for stop in (False, True):
                calls.append(lambda p=policy, c=call, st=stop: {
                    k: torch.as_tensor(np.asarray(v))
                    for k, v in cb.rollout(p, gen.manual_seed(c),
                                           stop_at_done=st).items()})
        out, seconds = timed_calls(calls)
        return out, cb.graphs, seconds

    return graph_pair("eval_callback", run)


def phase_graphs(device):
    """Phase 15: the port's CUDA graphs against its eager loops.  Returns
    (launch counts of the graphed runs by scene, report)."""
    from vnl_tpu_torch import bench
    from vnl_tpu_torch.envs import (AntTracking, HumanoidTracking,
                                    make_twin_env, wrap_for_training)
    from vnl_tpu_torch.profile_rollout import profile_rollout
    from vnl_tpu_torch.profile_train import profile_train
    from vnl_tpu_torch.utils import graphs
    t_phase = time.perf_counter()
    rep, counts = {}, {}
    for fused in (True, False):
        tag = "twin_" + ("fused" if fused else "unfused")
        counts[tag], rep[tag] = rollout_pair(
            tag, make_twin_env(device=device, fused_position=fused),
            keeper_policy)
    for tag, env in (("humanoid", HumanoidTracking(device=device)),
                     ("ant", AntTracking(device=device))):
        counts[tag], rep[tag] = rollout_pair(
            tag, wrap_for_training(env, episode_length=150),
            intention_policy(env))
    counts["training"], rep["training"] = train_pair(device)
    for tag, pair in (("evaluator", evaluator_pair),
                      ("eval_checkpoint_noise", eval_checkpoint_pair),
                      ("eval_callback", callback_pair)):
        counts[tag], rep[tag] = pair(device)

    steps = {}
    for graphed in (False, True):
        steps[graphed] = bench.run_stepping(
            device, batch=BATCH, n_steps=UNROLL, samples=STEPPING_SAMPLES,
            warmup=2, cuda_graphs=graphed)
    diff = differing(steps[False]["state"], steps[True]["state"])
    if diff or steps[False]["launches_per_sample"] != \
            steps[True]["launches_per_sample"]:
        raise AssertionError(f"stepping: graphed differs from eager in "
                             f"{diff[:8]}, launches "
                             f"{steps[False]['launches_per_sample']} / "
                             f"{steps[True]['launches_per_sample']}")
    counts["stepping"] = add_counts(*steps[True]["launches_per_sample"])
    rep["stepping"] = {
        f"{tag}_{k}": steps[g][k] for tag, g in (("eager", False),
                                                 ("graphed", True))
        for k in ("value", "median", "sample_env_steps_per_s")}
    rep["stepping"]["graph"] = steps[True]["graph"]

    rep["profile_rollout"] = {tag: profile_rollout(g) for tag, g in (
        ("eager", False), ("graphed", True))}
    rep["profile_train_fused"] = {
        tag: profile_train(True, g, evaluation=False)
        for tag, g in (("eager", False), ("graphed", True))}
    rep["profile_train_unfused"] = {
        tag: profile_train(False, g, evaluation=False, trace=False)
        for tag, g in (("eager", False), ("graphed", True))}
    for key in ("profile_train_fused", "profile_train_unfused"):
        for r in rep[key].values():
            r.pop("name_and_power_limit", None)
    rep["captures"] = {
        "count": len(graphs.REPORTS),
        "by_name": {name: {k: [g[k] for g in graphs.REPORTS
                               if g["name"] == name]
                           for k in ("capture_s", "instantiate_s", "nodes",
                                     "pool_bytes")}
                    for name in sorted({g["name"] for g in graphs.REPORTS})}}
    rep["name_and_power_limit"] = bench.gpu_name_and_power_limit()
    rep["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"graphs": rep}), flush=True)
    return {"twin": add_counts(counts["twin_fused"], counts["twin_unfused"],
                               counts["training"], counts["stepping"],
                               counts["evaluator"],
                               counts["eval_checkpoint_noise"],
                               counts["eval_callback"]),
            "humanoid": counts["humanoid"], "ant": counts["ant"]}, rep


HUMANOID_RUN_DIR = os.path.join(ROOT, "build", "run_humanoid_smoke")


def phase_cliplib_humanoid(device):
    """Phase 16: the clip-library probe at BATCH envs and 2, 8 and 64
    clips, then the humanoid learning run for two intervals of two
    training steps at BATCH envs with three evaluations of 256 envs
    replaying one graph.  Returns (launch counts of the probe, of the
    humanoid run, report)."""
    from vnl_tpu_torch import bench, bench_cliplib, models, run_humanoid
    t_phase = time.perf_counter()
    rep = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    rows = bench_cliplib.run(BATCH, bench_cliplib.SIZES, device)
    counts_clip = dict(launch_counts)
    need = 5 * bench_cliplib.STEPS
    for n, row in zip(bench_cliplib.SIZES, rows):
        st = row.pop("state")
        finite = all(bool(torch.isfinite(x).all()) for x in (
            st.pipeline_state.qpos, st.pipeline_state.qvel, st.reward,
            st.obs))
        lp = row["launches_per_sample"]
        if not finite or row["clips"] != n or \
                len(row["clip_ids"]) != n or sum(row["clip_ids"]) != BATCH \
                or lp["position"] < need or lp["cg"] < need:
            raise AssertionError(f"cliplib at {n} clips: finite {finite}, "
                                 f"clips {row['clips']}, ids "
                                 f"{len(row['clip_ids'])}, launches {lp}")
        row["clip_ids"] = len(row["clip_ids"])
    rates = [r["env_steps_per_s"] for r in rows]
    rep["cliplib"] = dict(rows=rows, flatness=min(rates) / max(rates))

    made = {}

    def factory(*a, **kw):
        made["net"] = models.make_intention_ppo_networks(*a, **kw)
        made["init"] = {k: v.clone()
                        for k, v in made["net"].state_dict().items()}
        return made["net"]

    kw = run_humanoid.train_kwargs(device)
    per_step = kw["batch_size"] * kw["unroll_length"] * kw["num_minibatches"]
    torch.cuda.synchronize()
    reset_launch_counts()
    rec = run_humanoid.run(4 * per_step, BATCH, device, HUMANOID_RUN_DIR,
                           num_evals=3, network_factory=factory)
    counts_h = dict(launch_counts)
    rec.pop("params")
    with open(rec["metrics"]) as f:
        last = [json.loads(line) for line in f][-1]
    losses = {k: v for k, v in last.items() if k.startswith("training/")
              and "loss" in k}
    now = made["net"].state_dict()
    still = [k for k, v in made["init"].items()
             if k.endswith("weight") and torch.equal(v, now[k])]
    evals = [g for g in rec["graphs"] if g["name"] == "eval_step"]
    if not losses or not all(np.isfinite(v) for v in losses.values()) or \
            still or len(rec["curve"]) != 3 or len(evals) != 1 or \
            rec["env_steps"] != 4 * per_step or \
            counts_h.get("position", 0) < 100 or counts_h.get("cg", 0) < 100:
        raise AssertionError(f"run_humanoid: losses {losses}, unmoved "
                             f"{still[:4]}, curve {rec['curve']}, eval "
                             f"graphs {len(evals)}, launches {counts_h}")
    rep["run_humanoid"] = dict(
        {k: rec[k] for k in ("curve", "wall_s", "env_steps_per_s",
                             "training_env_steps_per_s_median", "eval_s")},
        losses=losses, launches=counts_h,
        eval_graph={k: evals[0][k] for k in ("capture_s", "instantiate_s",
                                             "nodes")})
    rep["name_and_power_limit"] = bench.gpu_name_and_power_limit()
    rep["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"cliplib_humanoid": rep}), flush=True)
    return counts_clip, counts_h, rep


def compare_trees(old: str) -> dict:
    """tools/compare_kernels.py --old ``old``: {key: {"old": ms, "new":
    ms}} of both trees' kernels, timed in turns."""
    import subprocess
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                       "compare_kernels.py"),
                          "--old", old], capture_output=True, text=True)
    if out.returncode != 0:
        raise AssertionError(f"compare_kernels: {out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    trees = {k: v for k, v in res.items() if k.endswith("_ms")}
    trees["position_same_bits"] = res["position_same_bits"]
    print(json.dumps({"compare_kernels": trees}), flush=True)
    return trees


def main() -> int:
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script drives "
                    "the port on a CUDA device")
    sys.path.insert(0, ROOT)
    from vnl_tpu_torch import compat

    p = argparse.ArgumentParser()
    p.add_argument("--out", default="",
                   help="also write the details as JSON to this file")
    p.add_argument("--old", default="",
                   help="an earlier tree of the port (a directory): time "
                        "its kernels and this tree's in turns "
                        "(tools/compare_kernels.py) and print both in "
                        "phases 8-9")
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
    row_bw, errs_bw = phase_kernel_b_widest(gen)
    row_d, errs_d = phase_kernel_d(m, gen)
    rows_e, errs_e = phase_kernel_e(device, gen)
    rows_f, errs_f = phase_kernel_f(gen)
    counts, info["rollout"] = phase_rollout(device)
    row_c, errs_c = phase_kernel_c(m, gen)
    counts_fused, info["training_fused"] = phase_training(True, steps=2)
    counts_unfused, info["training_unfused"] = phase_training(False, steps=1)
    info["cli"], counts_cli = phase_cli(device)
    trees = compare_trees(args.old) if args.old else None
    rows_h, counts_h, info["humanoid"], errs_h = phase_humanoid(device, trees)
    rows_ant, counts_ant, info["ant"], errs_ant = phase_ant(device, trees)
    info["render"] = phase_render(device)
    counts_dp, info["data_parallel"] = phase_data_parallel(device)
    info["checkpoint_tools"], counts_tools = phase_checkpoint_tools(device)
    counts_step, info["stepping"] = phase_stepping(device)
    counts_num, row_ch, info["numerics"] = phase_numerics(
        device, os.path.dirname(os.path.abspath(args.out)) if args.out
        else "")
    counts_graphs, info["graphs"] = phase_graphs(device)
    counts_clip, counts_run_h, info["cliplib_humanoid"] = \
        phase_cliplib_humanoid(device)
    counts_cmu, info["cmu"] = phase_cmu(device)
    twin_counts = add_counts(counts, counts_fused, counts_unfused,
                             *counts_cli, counts_dp, counts_tools,
                             counts_step, counts_num["twin"],
                             counts_graphs["twin"], counts_clip)
    counts_h = add_counts(counts_h, counts_num["humanoid"],
                          counts_graphs["humanoid"], counts_run_h)
    counts_ant = add_counts(counts_ant, counts_num["ant"],
                            counts_graphs["ant"])
    kernels = [row_a, row_b, row_bw, row_d] + rows_e + rows_f + [row_c] + \
        rows_h + rows_ant + [row_ch]
    for row in kernels:
        # each shape's launches on the paths that run it (the twin's rows:
        # phases 4, 6, 7, 11, 12, 13, 14, 15, 16; the humanoid's: 8, 14,
        # 15, 16, where C's n 27 pair runs only in 14; the ant's: 9, 14,
        # 15; the CMU humanoid's: 17; phase 15 counts its graphed runs),
        # each path counted from zero on its own
        paths = (counts_h if row["name"].endswith("humanoid") else
                 counts_cmu if row["name"].endswith("cmu") else
                 counts_ant if "ant" in row["name"] else twin_counts)
        counter = row.pop("counter", row["kernel"])
        row["launches"] = paths.get(counter, 0)
        if row["launches"] < 1:
            raise AssertionError(f"kernel {row['name']} never launched on "
                                 "its paths")
    info["details"] = dict({"position": errs_a, "cg": errs_b,
                            "cg_widest": errs_bw, "constraints": errs_d,
                            "collision": errs_e, "gae": errs_f,
                            "sweep": errs_c},
                           **errs_h, **errs_ant)

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
