"""The port's device-numerics check (counterpart of
tools/check_tpu_numerics.py): rollouts and forward passes of the port held
against goldens that vnl_tpu computed on the CPU.

The goldens are numpy files under vnl_tpu_torch/assets/goldens/, written
by ``python tools/export_torch_assets.py --goldens``; this module reads
only them.  vnl_tpu ran its unfused position stage there (the refining
one in env steps; each file's ``position_stage``).

*Rollout drift.*  Each rollout golden holds 16 envs of a raw env (no
wrappers, no auto-reset) over 20 control steps: the start frames and
reset noise, the actions (for ``twin_keeper``: the keeper's deterministic
policy in the loop, with its intention draws), every step's qpos, qvel,
obs, reward and done, and ``spread``: each step's largest |qpos - qpos'|
of vnl_tpu's own rollout started one float32 ulp away.  The 16 envs are
tiled to ``batch`` envs (the goldens of one scene in one batch, each in a
block of its own), reset with the stored draws and stepped with the
stored actions (the keeper's: the port's policy, fed the stored
intention draws, and its actions compared too), once with the fused
position stage (kernel A, the main path) and once unfused (kernel C).
Contact dynamics are chaotic, so only the early steps are held tightly
(tests/test_golden.py:88-98):
- steps 1-5: max |dqpos| <= max(5e-4, 4 spread_t) over all envs;
- every step: max |dreward| <= 1e-2; the keeper's actions at steps 1-5
  within the same 1e-2.
The full-horizon |dqpos| and the number of copies equal to copy 0 bit for
bit are printed for information.

*Forward.*  128 states a scene (twin, humanoid, ant) made as
tools/check_tpu_numerics.py:64-66 makes them; forward() with the fused
stage (A then B, or A and Newton with C on the ant) and unfused (C):
max |dqacc| < 5e-2 max(|qacc| scale, 1) (check_tpu_numerics.py:86); max
|dqfrc_constraint| is printed.

On a CUDA device every part must launch its kernels (``ops.
launch_counts``): A and B on the twin and the humanoid, A and C on the
ant, E on all three, C in every unfused part (n 27 on the humanoid).
Any miss exits non-zero.  With ``--device cpu`` the kernel wrappers run
their plain versions and the launch counts are not asserted.

  python -m vnl_tpu_torch.check_numerics [--device cuda|cpu]
      [--batch 1024] [--out FILE]

Prints a drift table a scene and one ``{"check_numerics": ...}`` JSON
line.  Runs on ``cuda`` unless ``--device cpu``; raises without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vnl_tpu_torch.ops import launch_counts, reset_launch_counts
from vnl_tpu_torch.physics import forward as fwd

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "assets", "goldens")
ROLLOUTS = ("twin_actions", "twin_keeper", "humanoid_actions", "ant_actions")
FORWARDS = ("twin", "humanoid", "ant")
EARLY_STEPS = 5
QPOS_ATOL = 5e-4        # tests/test_golden.py:97
SPREAD_FACTOR = 4.0
REWARD_ATOL = 1e-2      # tests/test_golden.py:98
ACTION_ATOL = 1e-2
FORWARD_RTOL = 5e-2     # tools/check_tpu_numerics.py:86
SUBSTEPS = 5            # physics steps a control step in every scene
RK4_PASSES = 4          # forward passes a physics step on the ant


def load_golden(name: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(GOLDENS, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def make_env(scene: str, device, fused: bool):
    """The port's env of a golden's scene, as the exporter built vnl_tpu's:
    the twin with its clip, HumanoidTracking and AntTracking on the
    committed scenes with their defaults."""
    from vnl_tpu_torch.envs import AntTracking, HumanoidTracking
    from vnl_tpu_torch.envs import make_twin_env
    if scene == "twin":
        return make_twin_env(device=device, fused_position=fused)
    cls = HumanoidTracking if scene == "humanoid" else AntTracking
    return cls(device=device, fused_position=fused)


def expected_launches(scene: str, fused: bool, steps: int) -> dict:
    """{kernel: least launches} of a part of ``steps`` control steps (0: one
    forward pass) of one batch, and ``0`` for the position kernel where
    the stage is unfused: A and B on the twin and the humanoid, A and C
    (Newton's H^-1) on the ant, and E on all three, in every forward
    pass; unfused, C instead of A, at least once a control step (its
    first substep inverts exactly, the others refine)."""
    passes = max(steps * SUBSTEPS * (RK4_PASSES if scene == "ant" else 1), 1)
    need = {"position": passes} if fused else {"position": 0,
                                               "sweep": max(steps, 1)}
    need["sweep" if scene == "ant" else "cg"] = passes
    need["collision"] = passes
    return need


def launch_misses(counts: dict, need: dict) -> list:
    return [f"{k}: {counts.get(k, 0)} launches, expected "
            f"{'none' if least == 0 else f'>= {least}'}"
            for k, least in need.items()
            if (counts.get(k, 0) != 0 if least == 0
                else counts.get(k, 0) < least)]


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|; a NaN counts as infinitely far."""
    d = torch.nan_to_num((a - b).abs(), nan=float("inf"))
    return float(d.max()) if d.numel() else 0.0


def check_rollouts(names: Sequence[str], env, batch: int,
                   n_envs: Optional[int] = None,
                   n_steps: Optional[int] = None,
                   keep: bool = False) -> Dict[str, dict]:
    """The rollout goldens ``names`` of one scene on ``env``, stepped as one
    batch: each golden's first ``n_envs`` envs tiled to ``batch`` (at least
    one copy) in a block of their own, ``n_steps`` control steps.  Returns
    for each golden the per-step drift (``steps``: qpos, qvel, obs, reward,
    actions, done mismatches), the tolerances, ``ok`` and, with ``keep``,
    the port's arrays of copy 0 (``trace``)."""
    from vnl_tpu_torch import compat
    from vnl_tpu_torch.models import make_inference_fn
    gs = {name: load_golden(name) for name in names}
    first = gs[names[0]]
    n_envs = n_envs or first["qpos"].shape[1]
    n_steps = n_steps or first["qpos"].shape[0] - 1
    copies = max(1, batch // n_envs)
    per = copies * n_envs
    block = {name: slice(i * per, (i + 1) * per)
             for i, name in enumerate(names)}
    dev = env.sys.device

    def tile(x):
        x = np.asarray(x)[:n_envs]
        return torch.as_tensor(np.tile(x, (copies,) + (1,) * (x.ndim - 1)),
                               device=dev)

    def stacked(key):
        return torch.cat([tile(gs[name][key]) for name in names])

    kw = {"start_frame": stacked("start_frame").long()}
    if "noise" in first:
        kw["noise"] = stacked("noise")
    policy = None
    if any("latent_noise" in g for g in gs.values()):
        policy = make_inference_fn(compat.policy_from_numpy(
            compat.KEEPER_POLICY, device=dev))(deterministic=True)
    state = env.reset(per * len(names), **kw)
    same = {name: torch.ones(copies, dtype=torch.bool, device=dev)
            for name in names}
    first_parted = {name: None for name in names}
    rows = {name: [] for name in names}
    trace = {name: [] for name in names}

    def record(t, state, action=None):
        d = state.pipeline_state
        for name, g in gs.items():
            b = block[name]
            qc = d.qpos[b].reshape(copies, n_envs, -1)
            same[name] &= (qc == qc[:1]).flatten(1).all(1)
            if first_parted[name] is None and not bool(same[name].all()):
                first_parted[name] = t
            row = {"step": t,
                   "qpos": _max_abs(d.qpos[b], tile(g["qpos"][t])),
                   "qvel": _max_abs(d.qvel[b], tile(g["qvel"][t])),
                   "obs": _max_abs(state.obs[b], tile(g["obs"][t])),
                   "reward": _max_abs(state.reward[b], tile(g["reward"][t])),
                   "done_mismatch": int((state.done[b] != tile(g["done"][t]))
                                        .sum())}
            keeper = action is not None and "latent_noise" in g
            if keeper:
                row["actions"] = _max_abs(action[b],
                                          tile(g["actions"][t - 1]))
            rows[name].append(row)
            if keep:
                head = slice(b.start, b.start + n_envs)
                trace[name].append({
                    "qpos": qc[0].cpu().numpy(),
                    "obs": state.obs[head].cpu().numpy(),
                    "reward": state.reward[head].cpu().numpy(),
                    "done": state.done[head].cpu().numpy(),
                    "actions": action[head].cpu().numpy() if keeper
                    else None})

    record(0, state)
    for t in range(n_steps):
        actions = []
        for name, g in gs.items():
            b = block[name]
            if "latent_noise" in g:
                a, _ = policy(state.info["traj"][b], state.obs[b],
                              latent_noise=tile(g["latent_noise"][t]))
            else:
                a = tile(g["actions"][t])
            actions.append(a)
        action = torch.cat(actions)
        state = env.step(state, action)
        record(t + 1, state, action)

    early = range(1, min(EARLY_STEPS, n_steps) + 1)
    out = {}
    for name, g in gs.items():
        r = rows[name]
        tol = [max(QPOS_ATOL, SPREAD_FACTOR * float(g["spread"][t]))
               for t in early]
        reward = max(x["reward"] for x in r[1:])
        acts = (max(r[t]["actions"] for t in early)
                if "latent_noise" in g else None)
        ok = (all(r[t]["qpos"] <= tol[t - 1] for t in early)
              and reward <= REWARD_ATOL
              and (acts is None or acts <= ACTION_ATOL))
        out[name] = {"envs": per, "copies": copies, "steps": r,
                     "tol_qpos": tol,
                     "early_qpos": max(r[t]["qpos"] for t in early),
                     "full_horizon_qpos": max(x["qpos"] for x in r[1:]),
                     "max_reward": reward, "early_actions": acts,
                     "bitwise_copies": int(same[name].sum()),
                     "first_parted_step": first_parted[name], "ok": ok}
        if keep:
            out[name]["trace"] = trace[name]
    return out


def check_rollout(name: str, env, batch: int, n_envs: Optional[int] = None,
                  n_steps: Optional[int] = None, keep: bool = False) -> dict:
    """``check_rollouts`` of one golden."""
    return check_rollouts([name], env, batch, n_envs, n_steps, keep)[name]


def check_forward(scene: str, env, n: Optional[int] = None,
                  keep: bool = False) -> dict:
    """forward() on the first ``n`` states of ``forward_<scene>`` with the
    env's position stage, against the golden's qacc at FORWARD_RTOL of its
    scale; ``keep`` adds the port's qacc and qfrc_constraint."""
    g = load_golden(f"forward_{scene}")
    m, dev = env.sys, env.sys.device
    n = n or g["qpos"].shape[0]
    qpos = torch.as_tensor(g["qpos"][:n], device=dev)
    qvel = torch.as_tensor(g["qvel"][:n], device=dev)
    d = fwd.forward(m, fwd.make_data(m, n, qpos=qpos, qvel=qvel),
                    fused_position=env.fused_position)
    want = torch.as_tensor(g["qacc"][:n], device=dev)
    scale = float(want.abs().max())
    dq = _max_abs(d.qacc, want)
    out = {"states": n, "contacts": int((d.contact_dist < 0).sum()),
           "qacc": dq, "qacc_scale": scale,
           "tol_qacc": FORWARD_RTOL * max(scale, 1.0),
           "qfrc_constraint": _max_abs(
               d.qfrc_constraint,
               torch.as_tensor(g["qfrc_constraint"][:n], device=dev))}
    out["ok"] = dq < out["tol_qacc"]
    if keep:
        out["got"] = {k: getattr(d, k).cpu().numpy()
                      for k in ("qacc", "qfrc_constraint")}
    return out


def _counted(device, fn):
    """fn() with the launch counts taken from zero; returns (result,
    counts)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    reset_launch_counts()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, dict(launch_counts)


def run(device="cuda", batch: int = 1024) -> dict:
    """Every part of the check: each rollout golden (the goldens of a scene
    stepped as one batch, ``batch`` envs each) and each forward golden,
    with the fused and then the unfused position stage; prints the
    tables.  Returns the report; ``report["ok"]`` is False if any part
    failed its tolerances or, on a CUDA device, missed a kernel launch
    (``failures``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("check_numerics: no CUDA device (pass "
                           "--device cpu to run the plain versions)")
    fwd.pin_fp32()
    t0 = time.perf_counter()
    report = {"device": str(device), "batch": batch, "rollouts": {},
              "forward": {}, "parts": [], "failures": []}

    envs = {}

    def part(kind, scene, fused, names, steps, fn):
        """fn(env) counted from zero: records the part, its time and
        launches, and a failure if it missed a kernel."""
        if (scene, fused) not in envs:
            envs[scene, fused] = make_env(scene, device, fused)
        env = envs[scene, fused]
        t = time.perf_counter()
        res, counts = _counted(device, lambda: fn(env))
        stage = "fused" if fused else "unfused"
        misses = (launch_misses(counts, expected_launches(scene, fused,
                                                          steps))
                  if device.type == "cuda" else [])
        report["parts"].append(dict(
            kind=kind, scene=scene, stage=stage, goldens=names,
            s=time.perf_counter() - t, launches=counts, misses=misses))
        if misses:
            report["failures"].append(f"{kind} {scene} {stage}: {misses}")
        return res, stage

    by_scene = {}
    for name in ROLLOUTS:
        by_scene.setdefault(str(load_golden(name)["scene"]), []).append(name)
    for scene, names in by_scene.items():
        steps = load_golden(names[0])["qpos"].shape[0] - 1
        for fused in (True, False):
            res, stage = part("rollout", scene, fused, names, steps,
                              lambda env: check_rollouts(names, env, batch))
            for name, r in res.items():
                report["rollouts"].setdefault(name, {})[stage] = r
                if not r["ok"]:
                    report["failures"].append(
                        f"{name} {stage}: early qpos {r['early_qpos']:.3e} "
                        f"(tol {min(r['tol_qpos']):.1e}), reward "
                        f"{r['max_reward']:.3e}, actions "
                        f"{r['early_actions']}")
    for scene in FORWARDS:
        for fused in (True, False):
            r, stage = part("forward", scene, fused, [f"forward_{scene}"], 0,
                            lambda env: check_forward(scene, env))
            report["forward"].setdefault(scene, {})[stage] = r
            if not r["ok"]:
                report["failures"].append(
                    f"forward {scene} {stage}: qacc {r['qacc']:.3e} (tol "
                    f"{r['tol_qacc']:.3e})")
    report["s"] = time.perf_counter() - t0
    report["ok"] = not report["failures"]
    print_tables(report)
    return report


def print_tables(report: dict) -> None:
    """A drift table a rollout golden (max |dqpos| a step, fused and
    unfused, the early tolerance) and a line a forward scene."""
    for name, stages in report["rollouts"].items():
        first = next(iter(stages.values()))
        print(f"{name}: {first['envs']} envs ({first['copies']} copies); "
              f"max |dqpos| a step (steps 1-{len(first['tol_qpos'])} held "
              "at tol)", flush=True)
        print("  step " + " ".join(f"{s:>9}" for s in stages) + "       tol")
        for t in range(1, len(first["steps"])):
            tol = (f"{first['tol_qpos'][t - 1]:9.2e}"
                   if t <= len(first["tol_qpos"]) else "")
            print(f"  {t:4d} " + " ".join(
                f"{r['steps'][t]['qpos']:9.2e}" for r in stages.values())
                + f" {tol}")
        for stage, r in stages.items():
            acts = ("" if r["early_actions"] is None else
                    f", early |daction| {r['early_actions']:.2e}")
            print(f"  {stage}: max |dreward| {r['max_reward']:.2e}, "
                  f"full-horizon |dqpos| {r['full_horizon_qpos']:.2e}"
                  f"{acts}, copies equal to copy 0 bit for bit "
                  f"{r['bitwise_copies']}/{r['copies']}"
                  + ("" if r["first_parted_step"] is None else
                     f" (parted after step {r['first_parted_step']})")
                  + ", "
                  f"{'PASS' if r['ok'] else 'FAIL'}", flush=True)
    for scene, stages in report["forward"].items():
        for stage, r in stages.items():
            print(f"forward {scene} {stage} ({r['states']} states, "
                  f"{r['contacts']} contacts): max |dqacc| {r['qacc']:.2e} "
                  f"(tol {r['tol_qacc']:.2e}, scale {r['qacc_scale']:.1f}), "
                  f"max |dqfrc_constraint| {r['qfrc_constraint']:.2e} "
                  f"{'PASS' if r['ok'] else 'FAIL'}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=1024,
                   help="envs a rollout (the 16 of a golden, tiled)")
    p.add_argument("--out", default="", help="also write the report here")
    args = p.parse_args(argv)
    report = run(args.device, args.batch)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"check_numerics": report}), flush=True)
    for msg in report["failures"]:
        print(f"check_numerics: FAILED: {msg}", file=sys.stderr, flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
