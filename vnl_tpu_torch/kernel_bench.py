"""Inputs, timing and per-stage split of the hand-written kernels A, B and
C on one CUDA device, at the shapes the rollout gives them (the rodent
twin, B envs; for C the stacked pair [qM, qM + h diag(B)] of B envs).

``stage_split`` times, at the model's shapes (``scene``: the humanoid's or
the ant's), kernel A whole and with its sweeps, its subtree sums,
the doubling rounds of its tree walk, its qM assembly or all four left out
(the profiling ``skip`` bits of ``ops.position._launch``), and kernel B
whole, with no line search, with no CG iteration and with its chain walks
or matvecs left out (``ops.cg._launch``'s ``skip`` bits), and kernel C
whole, with its pivot loop left out and with loads and stores only
(``ops.sweep._launch``'s ``skip`` bits; on a Newton model its first
iteration's Hessians, else the stacked pair), beside one launch of a
one-element torch add, the floor of a launch in this timer, and reads
each kernel's registers, local-memory bytes, shared memory and resident
blocks per SM.  ``check_cg`` is the yardstick that holds kernel B against
its plain version; ``constraint_states`` makes kernel D's inputs;
``check_collision`` holds kernel E against its plain version on the CPU,
on the narrowphase tests' scenes (``BOX_SCENE``, ``ROUND_SCENE``,
``ELLIPSOID_SCENE``: every pair type between them) and poses
(``collision_states``).  ``python3 -m vnl_tpu_torch.profile_rollout`` prints
it as one JSON line; ``chip_smoke.py`` takes its inputs and its timer
from here.
"""

from __future__ import annotations

import numpy as np
import torch

from vnl_tpu_torch.ops import cg as cg_ops
from vnl_tpu_torch.ops import constraints as constraint_ops
from vnl_tpu_torch.ops import position as position_ops
from vnl_tpu_torch.ops import sweep as sweep_ops
from vnl_tpu_torch.physics import (actuation, collision, constraint, forward,
                                   inertia, solver)
from vnl_tpu_torch.physics.model import GeomType, SolverType


def time_ms(fn, reps: int = 20, warmup: int = 3, queued: int = 0) -> float:
    """Median device time of one call of ``fn`` (CUDA events).

    ``queued = 0``: events around each single call; for work that takes
    longer on the device than the host needs to enqueue it.
    ``queued = n``: for one short kernel.  The stream is first held busy by
    a spin kernel, so the n calls are enqueued while the device waits and
    the time between the events is the kernels' own, not the host's time
    between launches; returns the time over n."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(8_000_000)        # a few ms of device time
        a.record()
        for _ in range(max(queued, 1)):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / max(queued, 1))
    return float(np.median(times))


QUEUED = 8      # launches per timed batch of a hand-written kernel


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


def _solve_inputs(m, batch, gen, press):
    """Kernel-A states with the root lowered by ``press``, through
    collision, constraints and the smooth dynamics: (data, constraint
    system, qacc_smooth, number of active contacts).  The system is
    make_constraints' on every device: kernel B's yardstick holds it to
    its plain version on the plain assembly's systems, which kernel D
    (tested on its own) gives to within a rounding that moves with the
    batch (cuBLAS picks the order of the plain J qvel sums by shape)."""
    qpos = random_states(m, batch, gen)
    qpos[:, 2] -= press
    qvel = 0.5 * torch.randn(batch, m.nv, generator=gen, device=m.device)
    d = forward.make_data(m, batch, qpos=qpos, qvel=qvel)
    d, _ = forward.fwd_position(m, d)
    efc = constraint.make_constraints(m, d, d.contact_dist, d.contact_pos,
                                      d.contact_frame,
                                      collision.pair_expansion(m))
    d = forward.fwd_velocity(m, d)
    _, qfrc_act, _ = actuation.actuation(m, d)
    qacc_smooth = inertia.solve_m(d, d.qfrc_passive - d.qfrc_bias + qfrc_act)
    return d, efc, qacc_smooth, int((d.contact_dist < 0).sum())


def contact_states(m, batch, gen, press: float = 0.005):
    """Kernel-A states pressed into the floor (the root lowered by
    ``press``), through collision and constraints, up to the CG solve's
    inputs: ((args, statics), number of active contacts)."""
    d, efc, qacc_smooth, active = _solve_inputs(m, batch, gen, press)
    return cg_ops.cg_inputs(m, d, efc, qacc_smooth,
                            max(m.opt.iterations, 1)), active


# contact distances of ``constraint_states(edges=True)``, in widths of the
# contact's solimp from margin - gap: past it on both sides of the
# sigmoid's midpoint and beyond its width, just inside, at it (inactive)
# and outside
EDGE_STEPS = (-3.0, -1.0, -0.75, -0.5, -0.25, -1e-3, 0.0, 1e-3, 0.5, 3.0)


def constraint_states(m, batch, gen, press: float = 0.005,
                      edges: bool = False):
    """Kernel D's inputs at kernel-A states with the root lowered by
    ``press``, through the position stage and collision: (data, con_dist,
    con_pos, con_frame, con_pair).  ``edges``: the hinges drawn up to 10%
    of their ranges past either end (limit rows on both sides and
    violated), and contact c of env b at the distance EDGE_STEPS[(b + c) %
    10] widths from its margin - gap."""
    dev = m.device
    qpos = random_states(m, batch, gen)
    if edges:
        lo, hi = m.jnt_range[1:, 0], m.jnt_range[1:, 1]
        u = 1.2 * torch.rand(batch, m.nq - 7, generator=gen, device=dev) - 0.1
        qpos[:, 7:] = lo + u * (hi - lo)
    qpos[:, 2] -= press
    qvel = 0.5 * torch.randn(batch, m.nv, generator=gen, device=dev)
    d, _ = forward.fwd_position(m, forward.make_data(m, batch, qpos=qpos,
                                                     qvel=qvel))
    pair = collision.pair_expansion(m)
    dist = d.contact_dist
    if edges:
        t = constraint_ops.kernel_tables(m, pair)["con_flt"]
        field = constraint_ops.CONTACT_FIELDS.index
        thresh, width = (torch.as_tensor(t[field(n)], device=dev)
                         for n in ("thresh", "width"))
        steps = torch.tensor(EDGE_STEPS, device=dev)
        k = (torch.arange(batch, device=dev)[:, None]
             + torch.arange(len(pair), device=dev)) % len(EDGE_STEPS)
        dist = thresh + width * steps[k]
    return d, dist.contiguous(), d.contact_pos, d.contact_frame, pair


def padded_contacts(args, st, pad: int):
    """A contact system (``args``, ``st``, from contact_states) with ``pad``
    more contacts, copies of its first ones pushed 1e3 away from touching,
    so that they stay inactive and the solve is the original one; more
    than 1,024 contact rows take kernel B's widest route, cg_kernel<0>,
    which no scene of the repo reaches.  Returns (args, statics)."""
    reps = -(-pad // st.ncon)
    wide = cg_ops.CgStatics.make(
        st.nv, st.lim_dof, *[np.concatenate([c] + [c] * reps)[:st.ncon + pad]
                             for c in (st.chain1, st.chain2)],
        st.iters, st.ls_iters)
    args = list(args)
    args[4] = torch.cat([args[4]] + [args[4]] * reps,
                        2)[:, :, :st.ncon + pad].contiguous()
    for i in (8, 9, 10):
        args[i] = torch.cat([args[i]] + [args[i]] * reps,
                            1)[:, :st.ncon + pad].contiguous()
    args[9][:, st.ncon:] = -1e3         # far from touching: no force
    return args, wide


def newton_hessians(m, batch, gen, press: float = 0.005):
    """The Hessians H = M + J^T H_s J (batch, nv, nv) that the first
    Newton iteration inverts (kernel C's input on the Newton path) at
    kernel-A states pressed into the floor, and the number of active
    contacts.  ``m`` must compile for Newton (a dense contact Jacobian)."""
    d, efc, x, active = _solve_inputs(m, batch, gen, press)
    lim_jx, con_fx = efc.jx(x)
    H = solver.newton_hessian(d, efc, lim_jx - efc.lim_aref,
                              con_fx - efc.con_aref)
    return H.contiguous(), active


def cg_spread(st, args, ker, tol: float = 1e-3, base=None) -> dict:
    """Kernel B's outputs ``ker`` beside the plain version on the same
    inputs, in float32 and float64, per output: the largest
    |kernel - plain float32|, and per env (B,) masks: ``miss`` (beyond
    rtol = atol = ``tol`` of the float32 result), ``far`` (beyond it of
    both results) and ``unstable`` (the plain version's own float32 and
    float64 results beyond it of each other).  Raises on a non-finite
    output.  ``base``: the plain (float32, float64) results, if already
    computed."""
    plain, ref = base or (cg_ops.cg_plain(*args, statics=st),
                          cg_ops.cg_plain(*[a.double() for a in args],
                                          statics=st))

    def excess(got, want):      # per env, in units of atol + rtol |want|
        e = (got - want).abs() / (tol + tol * want.abs())
        return e.reshape(e.shape[0], -1).amax(1)

    out = {}
    for name, k, p, r in zip(("qacc", "qfrc_constraint", "con_f"), ker, plain,
                             ref):
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{name}: not finite")
        miss = excess(k, p) > 1.0
        out[name] = dict(err=(k - p).abs().reshape(k.shape[0], -1).amax(1),
                         miss=miss,
                         far=miss & (excess(k.double(), r) > 1.0),
                         unstable=excess(p.double(), r) > 1.0)
    return out


def check_cg(st, args, ker, tol: float = 1e-3, max_off: float = 0.005) -> dict:
    """Holds kernel B's outputs ``ker`` against the plain version on CUDA
    inputs ``args`` at rtol = atol = ``tol`` (the JAX tests' tolerance);
    raises AssertionError on a mismatch, else returns the errors.

    Every env is held to the plain version in float32.  The plain version
    has a rounding error of its own, and the two can lie on either side of
    the exact solve, each within the tolerance of it and a little more than
    the tolerance apart.  An env that misses the float32 result is
    therefore held, at the same tolerance, to the plain version run in
    float64 on the same inputs, and no more than ``max_off`` of a batch
    (none of a small one) may need that.  Returns per output the largest
    |kernel - plain float32| over all envs, ``off_envs`` (envs that needed
    the float64 result) and ``unstable_envs`` (envs on which the plain
    version's own float32 and float64 results differ by more than the
    tolerance)."""
    spread = cg_spread(st, args, ker, tol)
    batch = ker[0].shape[0]
    off = torch.zeros(batch, dtype=torch.bool, device=ker[0].device)
    unstable = off.clone()
    for name, e in spread.items():
        far = e["far"]
        if bool(far.any()):
            raise AssertionError(
                f"{name}: max |err| {float(e['err'][far].max()):.3e} "
                f"beyond rtol = atol = {tol} of the plain version in float32 "
                f"and in float64 on {int(far.sum())} envs of {batch}")
        off |= e["miss"]
        unstable |= e["unstable"]
    if int(off.sum()) > int(max_off * batch):
        raise AssertionError(
            f"{int(off.sum())} envs of {batch} beyond rtol = atol = {tol} of "
            f"the plain version in float32; at most {int(max_off * batch)} "
            "may be")
    return dict({k: float(e["err"].max()) for k, e in spread.items()},
                off_envs=int(off.sum()), unstable_envs=int(unstable.sum()))


def _far_off(spread):
    """(far, off) env counts of a cg_spread: beyond the tolerance of both
    plain results, and beyond it of the float32 one only."""
    far = off = None
    for e in spread.values():
        far = e["far"] if far is None else far | e["far"]
        off = e["miss"] if off is None else off | e["miss"]
    return int(far.sum()), int((off & ~far).sum())


def check_cg_reruns(st, args, ker, tol: float = 1e-3) -> dict:
    """Holds kernel B's outputs ``ker`` to the plain version as check_cg
    does env by env, but with a budget for systems whose float32 solve is
    not reproducible at ``tol``: the plain solve is re-run 4 times in
    float32 with its inputs scaled entry by entry by 1 + 2e-7 N(0, 1)
    (about one rounding), and counted like the kernel.  The kernel may
    leave at most twice as many envs beyond the tolerance of both plain
    results (``far``), and of the float32 result only (``off``), as the
    worst re-run does, plus 0.5% of the batch (check_cg's share); raises
    AssertionError otherwise (or on a non-finite output).  Returns the
    kernel's and the re-runs' counts and errors."""
    base = (cg_ops.cg_plain(*args, statics=st),
            cg_ops.cg_plain(*[a.double() for a in args], statics=st))
    spread = cg_spread(st, args, ker, tol, base)
    far, off = _far_off(spread)
    gen = torch.Generator(device=args[0].device).manual_seed(0)
    runs = []
    for _ in range(4):
        other = cg_ops.cg_plain(*[a * (1.0 + 2e-7 * torch.randn(
            a.shape, generator=gen, device=a.device, dtype=a.dtype))
            for a in args], statics=st)
        runs.append(_far_off(cg_spread(st, args, other, tol, base)))
    batch = ker[0].shape[0]
    budget_far = 2 * max(r[0] for r in runs) + int(0.005 * batch)
    budget_off = 2 * max(r[1] for r in runs) + int(0.005 * batch)
    if far > budget_far or off > budget_off:
        raise AssertionError(
            f"kernel B: {far} envs beyond rtol = atol = {tol} of the plain "
            f"version in float32 and float64 (at most {budget_far}), {off} "
            f"of float32 only (at most {budget_off}); the plain version "
            f"re-run at one rounding: {runs} of {batch}")
    return dict({k: float(e["err"].max()) for k, e in spread.items()},
                far_envs=far, off_envs=off, rerun_far_off=runs,
                budget_far=budget_far, budget_off=budget_off)


def _env_gap(out, ref) -> torch.Tensor:
    """Per env: the largest |out - ref| over kernel B's three outputs, each
    over its env's largest |ref| or 1 (the judge's measure of a state)."""
    gap = None
    for k, w in zip(out, ref):
        k, w = k.double().reshape(w.shape[0], -1), w.reshape(w.shape[0], -1)
        g = (k - w).abs().amax(1) / w.abs().amax(1).clamp(min=1.0)
        gap = g if gap is None else torch.maximum(gap, g)
    return gap


WIDEST_QUANTILES = (0.5, 0.9)


def check_cg_widest(st, args, ker, room: float = 3.0,
                    max_room: float = 10.0) -> dict:
    """Holds kernel B's outputs ``ker`` on a system whose float32 solve is
    not reproducible env by env (the CMU humanoid's 3,984 rows: re-runs of
    the plain float32 solve at one rounding leave half the envs beyond
    rtol = atol = 1e-3 of each other) by how far it lies from the plain
    version in float64, against how far the plain version's own float32
    solves lie.  Per env the gap is _env_gap's; the plain float32 solve
    and 4 re-runs with its inputs scaled entry by entry by 1 + 2e-7 N(0, 1)
    (about one rounding) give the rounding's reach.  The kernel's median
    and 90th percentile of the gap may be at most ``room`` times the
    largest of theirs, its largest gap ``max_room`` times theirs.  One CG
    iteration fewer reads about 0.66 at the median against 3e-5 to 6e-5
    for the plain re-runs, and g off by 1e-4 relative 1.7e-3 (CPU, 32
    envs).  Raises AssertionError (or on a non-finite output); returns the
    kernel's and the plain solves' quantiles."""
    for name, k in zip(("qacc", "qfrc_constraint", "con_f"), ker):
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{name}: not finite")
    ref = cg_ops.cg_plain(*[a.double() for a in args], statics=st)
    gen = torch.Generator(device=args[0].device).manual_seed(0)
    plain = [cg_ops.cg_plain(*args, statics=st)] + [
        cg_ops.cg_plain(*[a * (1.0 + 2e-7 * torch.randn(
            a.shape, generator=gen, device=a.device, dtype=a.dtype))
            for a in args], statics=st) for _ in range(4)]
    qs = torch.tensor(WIDEST_QUANTILES + (1.0,), dtype=torch.float64,
                      device=args[0].device)
    kq = [float(v) for v in torch.quantile(_env_gap(ker, ref), qs)]
    pq = [max(float(torch.quantile(_env_gap(p, ref), q)) for p in plain)
          for q in qs]
    out = dict(kernel=kq, plain=pq)
    rooms = [room] * len(WIDEST_QUANTILES) + [max_room]
    for q, k, p, r in zip(WIDEST_QUANTILES + (1.0,), kq, pq, rooms):
        if not k <= r * p:
            raise AssertionError(
                f"kernel B: quantile {q} of the envs' gap to the plain "
                f"version in float64 {k:.3e}, beyond {r} x the plain "
                f"float32 solves' {p:.3e}")
    return out


def twin_pair(m, qpos):
    """Kernel C's input on the unfused path: the stacked pair
    [qM, qM + h diag(B)] (2, B, nv, nv) at the states ``qpos``, with qM
    from kernel A."""
    qM = position_ops._launch(m, qpos)[11]
    hB = torch.diag(m.opt.timestep * m.dof_damping)
    return torch.stack([qM, qM + hB]).contiguous()


# ---- kernel E: the narrowphase tests' scenes, poses and yardstick ----

# every pair type beside the floor but capsules: plane-{sphere, cylinder,
# box}, sphere-box, box-box (the cylinder only meets the floor)
BOX_SCENE = """<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="cyl" pos="0 0 0.19"><freejoint/>
      <geom type="cylinder" size="0.1 0.2" density="300"/></body>
    <body name="box1" pos="1 0 0.08"><freejoint/>
      <geom type="box" size="0.1 0.12 0.08" density="300"/></body>
    <body name="box2" pos="1.03 0.02 0.25"><freejoint/>
      <geom type="box" size="0.09 0.1 0.09" density="300"/></body>
    <body name="ball" pos="1.0 0.2 0.1"><freejoint/>
      <geom type="sphere" size="0.1" density="300"/></body>
  </worldbody>
  <contact>
    <exclude body1="cyl" body2="box1"/><exclude body1="cyl" body2="box2"/>
    <exclude body1="cyl" body2="ball"/>
  </contact>
</mujoco>"""

# plane-{sphere, capsule, ellipsoid}, sphere-sphere, sphere-capsule,
# capsule-capsule
ROUND_SCENE = """<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="s1" pos="0 0 0.1"><freejoint/>
      <geom type="sphere" size="0.1"/></body>
    <body name="s2" pos="0.15 0.05 0.12"><freejoint/>
      <geom type="sphere" size="0.08"/></body>
    <body name="c1" pos="0.1 0.2 0.06" euler="0 90 0"><freejoint/>
      <geom type="capsule" size="0.05 0.2"/></body>
    <body name="c2" pos="0.15 0.25 0.12" euler="90 0 30"><freejoint/>
      <geom type="capsule" size="0.04 0.15"/></body>
  </worldbody>
</mujoco>"""

ELLIPSOID_SCENE = """<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="e" pos="0 0 0.1"><freejoint/>
      <geom type="ellipsoid" size="0.1 0.15 0.08"/></body>
  </worldbody>
</mujoco>"""


# every convex pair type (sphere, capsule and ellipsoid against an
# ellipsoid) between free bodies that overlap at their placement, and
# a capsule on the floor beside them
CONVEX_SCENE = """<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body pos="0 0 0.3"><freejoint/>
      <geom type="ellipsoid" size="0.06 0.03 0.045"/></body>
    <body pos="0.07 0.01 0.32" euler="0.3 0.5 0"><freejoint/>
      <geom type="ellipsoid" size="0.05 0.02 0.035"/></body>
    <body pos="-0.02 0.06 0.31" euler="0 1.2 0.4"><freejoint/>
      <geom type="capsule" size="0.02 0.05"/></body>
    <body pos="0.03 -0.05 0.28"><freejoint/>
      <geom type="sphere" size="0.025"/></body>
    <body pos="0.3 0 0.02" euler="0 1.5708 0"><freejoint/>
      <geom type="capsule" size="0.02 0.1"/></body>
  </worldbody>
</mujoco>"""


# geom 1 of deep_convex_poses by kind, and the ellipsoid (the CMU
# humanoid's hands)
DEEP_SIZES = dict(sphere=(0.03, 0.0, 0.0), capsule=(0.04, 0.1, 0.0),
                  ellipsoid=(0.03, 0.02, 0.05))
HAND = (0.042, 0.024, 0.054)
DEEP_SCENE = """<mujoco><option><flag gravity="disable"/></option><worldbody>
<body><freejoint/><geom type="{kind}" size="{s1}"/></body>
<body><freejoint/><geom type="ellipsoid" size="{s2}"/></body>
</worldbody></mujoco>"""


def deep_convex_scene(kind: str) -> str:
    """DEEP_SCENE with deep_convex_poses' geoms of ``kind``."""
    n = dict(sphere=1, capsule=2, ellipsoid=3)[kind]
    return DEEP_SCENE.format(kind=kind, s1=" ".join(
        map(str, DEEP_SIZES[kind][:n])), s2=" ".join(map(str, HAND)))


def deep_convex_poses(kind: str, n: int, seed: int):
    """``n`` poses of a ``kind`` geom (DEEP_SIZES) against the CMU
    humanoid's hand ellipsoid, geom 1's centre drawn in a 0.08-m cube
    around the ellipsoid's and both rotations at random: most cores
    overlap, where the support function H may have several local leasts
    on the sphere.  Returns float64 (x (n, 2, 3), R (n, 2, 3, 3)) of the
    two geoms and, from a grid of 8,000 directions, the greatest gap
    along any of them, (n,): at or below the signed distance."""
    gen = torch.Generator().manual_seed(seed)

    def rotations():
        q = torch.randn(n, 4, generator=gen, dtype=torch.float64)
        w, x, y, z = (q / q.norm(dim=-1, keepdim=True)).unbind(-1)
        return torch.stack([
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            -1).view(n, 3, 3)
    R1, R2 = rotations(), rotations()
    x1 = (2 * torch.rand(n, 3, generator=gen, dtype=torch.float64) - 1) * 0.04
    s1 = torch.tensor(DEEP_SIZES[kind], dtype=torch.float64)
    s2 = torch.tensor(HAND, dtype=torch.float64)
    k = torch.arange(8000, dtype=torch.float64) + 0.5
    polar, turn = torch.acos(1 - 2 * k / 8000), np.pi * (1 + 5 ** 0.5) * k
    dirs = torch.stack([torch.cos(turn) * torch.sin(polar),
                        torch.sin(turn) * torch.sin(polar), torch.cos(polar)],
                       -1)
    H = -x1 @ dirs.T + torch.einsum(
        "nij,kj->nki", s2[:, None] * R2.transpose(-1, -2), dirs).norm(dim=-1)
    if kind == "capsule":
        H = H + s1[1] * (R1[:, :, 2] @ dirs.T).abs()
    if kind == "ellipsoid":
        H = H + torch.einsum("nij,kj->nki", s1[:, None]
                             * R1.transpose(-1, -2), dirs).norm(dim=-1)
    r1 = s1[0] if kind != "ellipsoid" else 0.0
    x = torch.stack([x1, torch.zeros_like(x1)], 1)
    return (x, torch.stack([R1, R2], 1)), -H.min(-1).values - r1


def collision_states(qpos0, jnt_range, humanoid: bool, seed: int,
                     batch: int) -> np.ndarray:
    """qpos float32 (batch, nq) of a model with qpos0 and jnt_range: free
    bodies jittered in position and orientation around their placement
    (env 0 exactly at it), or the humanoid dropped near the floor with
    random limbs."""
    rng = np.random.default_rng(seed)
    qpos0 = np.asarray(qpos0, np.float64)
    nq = len(qpos0)
    qpos = np.tile(qpos0, (batch, 1))
    if humanoid:
        qpos[:, 2] = rng.uniform(0.1, 0.6, size=batch)
        quat = np.array([1.0, 0, 0, 0]) + 0.6 * rng.normal(size=(batch, 4))
        qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
        lo, hi = np.asarray(jnt_range[1:]).T
        qpos[:, 7:] = rng.uniform(lo, hi, size=(batch, len(lo)))
        return qpos.astype(np.float32)
    for a in range(0, nq, 7):                  # free joints only
        pos = 0.02 * rng.normal(size=(batch, 3))
        quat = np.array([1.0, 0, 0, 0]) + 0.15 * rng.normal(size=(batch, 4))
        pos[0], quat[0] = 0.0, [1.0, 0, 0, 0]
        qpos[:, a:a + 3] += pos
        q = qpos[:, a + 3:a + 7]
        qpos[:, a + 3:a + 7] = np.stack([
            quat[:, 0] * q[:, 0] - np.sum(quat[:, 1:] * q[:, 1:], 1),
            *(quat[:, 0:1] * q[:, 1:] + q[:, 0:1] * quat[:, 1:]
              + np.cross(quat[:, 1:], q[:, 1:])).T], 1)
        qpos[:, a + 3:a + 7] /= np.linalg.norm(qpos[:, a + 3:a + 7], axis=1,
                                               keepdims=True)
    return qpos.astype(np.float32)


def kept_slots(geom_type, pair_geom1, pair_geom2, con_pair):
    """Per plane-box or box-box candidate pair, the slots of its kept
    (deepest) points; and the mask of every other slot."""
    gt = np.asarray(geom_type)
    con_pair = np.asarray(con_pair)
    kept = gt[np.asarray(pair_geom2)[con_pair]] == GeomType.BOX
    kept &= gt[np.asarray(pair_geom1)[con_pair]] != GeomType.SPHERE
    groups = [np.nonzero(kept & (con_pair == p))[0]
              for p in np.unique(con_pair[kept])]
    return groups, ~kept


def assert_same_sets(tdist, tpos, jdist, jpos, name, atol=2e-5):
    """Each point (dist, pos) of the first pair of arrays matched one to one
    with a point of the second, per env, within ``atol``."""
    for b in range(tdist.shape[0]):
        free = list(range(tdist.shape[1]))
        for i in range(tdist.shape[1]):
            err = [max(abs(tdist[b, i] - jdist[b, j]),
                       np.abs(tpos[b, i] - jpos[b, j]).max()) for j in free]
            j = int(np.argmin(err))
            if not err[j] <= atol:
                raise AssertionError(f"{name}: env {b} point {i} is "
                                     f"{err[j]:.3e} from every point")
            free.pop(j)


def box_candidates(m, d):
    """{candidate pair: (dist (B, n), pos (B, n, 3))}: every candidate point
    of each plane-box (8 corners) and box-box pair (25) by the plain
    version, from which it keeps the deepest (4 and 8)."""
    out = {}
    for a, b, _, idx in collision._groups(m):
        if b != GeomType.BOX or a == GeomType.SPHERE:
            continue
        g1, g2 = m.index(m.pair_geom1[idx]), m.index(m.pair_geom2[idx])
        args = (d.geom_xpos[:, g1], d.geom_xmat[:, g1], m.geom_size[g1],
                d.geom_xpos[:, g2], d.geom_xmat[:, g2], m.geom_size[g2])
        fn = (collision._pp_box_candidates if a == GeomType.PLANE
              else collision._box_box_candidates)
        dist, pos = fn(*args)[:2]
        for i, p in enumerate(idx.tolist()):
            out[p] = (dist[:, i].cpu().numpy(), pos[:, i].cpu().numpy())
    return out


def assert_kept(tdist, tpos, wdist, cand_dist, cand_pos, name, atol=2e-5):
    """The points (tdist (B, k), tpos (B, k, 3)) that a pair keeps against
    the plain version's kept distances ``wdist`` and all its candidates:
    per env the same k depths, sorted, within ``atol``, and each point one
    of the candidates, one to one.  Candidates tied within rounding at the
    k-th depth may be kept either way."""
    for b in range(tdist.shape[0]):
        err = np.abs(np.sort(tdist[b]) - np.sort(wdist[b])).max()
        if not err <= atol:
            raise AssertionError(f"{name}: env {b} keeps depths {err:.3e} "
                                 "from the plain version's")
        free = list(range(cand_dist.shape[1]))
        for i in range(tdist.shape[1]):
            e = [max(abs(tdist[b, i] - cand_dist[b, j]),
                     np.abs(tpos[b, i] - cand_pos[b, j]).max()) for j in free]
            j = int(np.argmin(e))
            if not e[j] <= atol:
                raise AssertionError(f"{name}: env {b} point {i} is "
                                     f"{e[j]:.3e} from every candidate")
            free.pop(j)


def convex_slots(m, con_pair) -> np.ndarray:
    """The mask of the slots whose candidate pair is a convex pair type:
    a sphere, capsule or ellipsoid against an ellipsoid."""
    gt = np.asarray(m.geom_type)
    con_pair = np.asarray(con_pair)
    t1 = gt[np.asarray(m.pair_geom1)[con_pair]]
    t2 = gt[np.asarray(m.pair_geom2)[con_pair]]
    return (t2 == GeomType.ELLIPSOID) & (t1 != GeomType.PLANE)


def _vnorm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _convex_pairs64(m, d):
    """Per convex pair group, in slot order: (type 1, x1, R1, s1, x2, R2,
    s2) in float64 from the CPU model ``m`` and Data ``d``."""
    gx, gm = d.geom_xpos.double(), d.geom_xmat.double()
    size = m.geom_size.double()
    for a, b, _, idx in collision._groups(m):
        if b == GeomType.ELLIPSOID and a != GeomType.PLANE:
            g1, g2 = m.index(m.pair_geom1[idx]), m.index(m.pair_geom2[idx])
            yield a, gx[:, g1], gm[:, g1], size[g1], gx[:, g2], gm[:, g2], \
                size[g2]


def convex_plain64(m, d):
    """The plain version's (dist, pos, frame) of the convex slots
    (convex_slots, in slot order) in float64."""
    blocks = []
    for a, *args in _convex_pairs64(m, d):
        blocks += collision._NARROWPHASE[(a, GeomType.ELLIPSOID)](*args)
    return tuple(torch.cat([blk[k] for blk in blocks], 1) for k in range(3))


def convex_at_normal(m, d, normal, dist):
    """In float64, for each convex slot: the gap of its pair along
    ``normal`` (B, S, 3; geom 1 to geom 2), the least over geom 2 of n . b
    less the most over geom 1 of n . a (the signed distance is the
    greatest gap over all normals), and the contact point that normal and
    ``dist`` (B, S) give: the ellipsoid's support point in -normal moved
    back by half the distance, as collision._convex_contact places it."""
    gaps, points, k = [], [], 0
    for a, x1, R1, s1, x2, R2, s2 in _convex_pairs64(m, d):
        n = normal[:, k:k + x1.shape[1]].double()
        n = n / _vnorm(n)
        u = -n
        M2 = s2[..., :, None] * R2.transpose(-1, -2)
        Mu = torch.einsum("...ij,...j->...i", M2, u)
        val = torch.sum(u * (x2 - x1), -1) + _vnorm(Mu)[..., 0]
        if a == GeomType.ELLIPSOID:
            M1 = s1[..., :, None] * R1.transpose(-1, -2)
            val = val + _vnorm(torch.einsum("...ij,...j->...i", M1,
                                                u))[..., 0]
        else:
            val = val + s1[:, 0]
        if a == GeomType.CAPSULE:
            val = val + s1[:, 1] * torch.sum(u * R1[..., :, 2], -1).abs()
        gaps.append(-val)
        sup = x2 + torch.einsum("...ij,...j->...i", R2, s2 * Mu) \
            / _vnorm(Mu)
        points.append(sup - 0.5 * dist[:, k:k + x1.shape[1], None].double()
                      * n)
        k += x1.shape[1]
    return torch.cat(gaps, 1), torch.cat(points, 1)


def check_convex(got, want, m, d, convex) -> dict:
    """Kernel E's convex slots (mask ``convex``) against the plain version:
    distances within 2e-5 of its float32 result, as every pair's are.  The
    normal is the least of the support function H over the unit sphere,
    which float32 fixes only to about the square root of its rounding
    (near the least, H moves with the square of the step), and to less
    where the shapes press deep and H flattens.  So the normal is judged
    by what it is for, the distance along it: the gap along the kernel's
    normal (convex_at_normal, float64) short of the plain version's
    float64 distance by at most 2e-5, every distance's tolerance (the
    plain float32 normal falls short by up to 9e-7 on the CMU humanoid's
    states, where H is about 0.5 at far pairs).  The point must be the one the
    kernel's own normal and distance give, in float64, within 2e-5; the
    tangents those of its own normal (physics/collision.py _make_frame)
    within 2e-5: where the normal crosses _make_frame's switch (|n_z| =
    0.9) within its accuracy, kernel and plain version may pick other
    tangents, which a pyramidal cone with equal friction both ways takes
    alike.  Raises AssertionError; returns the errors, with the plain
    float32 normal's shortfall beside the kernel's."""
    ref = convex_plain64(m, d)
    g = [x[:, convex] for x in got[:3]]
    w = [x[:, convex] for x in want[:3]]
    gap, point = convex_at_normal(m, d, g[2][..., 0, :], g[0])
    plain_gap, _ = convex_at_normal(m, d, w[2][..., 0, :], w[0])
    frame = collision._make_frame(g[2][..., 0, :])
    errs = dict(
        convex_dist=float((g[0] - w[0]).abs().max()),
        convex_point=float((g[1].double() - point).abs().max()),
        convex_tangents=float((g[2] - frame).abs().max()),
        convex_shortfall=float((ref[0] - gap).max()),
        plain_shortfall=float((ref[0] - plain_gap).max()))
    for field, tol in (("convex_dist", 2e-5), ("convex_point", 2e-5),
                       ("convex_tangents", 2e-5),
                       ("convex_shortfall", 2e-5)):
        if not errs[field] <= tol:
            raise AssertionError(f"kernel E {field}: {errs[field]:.3e} "
                                 f"beyond {tol}")
    return errs


def check_collision(got, m, d, flat_env: bool = False) -> dict:
    """Kernel E's contacts ``got`` (collide's four outputs, on any device)
    against collision.collide (the plain version) of the CPU model ``m``
    on the CPU Data ``d``: distances, points and frames at atol 2e-5 (the
    narrowphase tests' tolerance); plane-box and box-box pairs by
    ``assert_kept``, their frames slot for slot; with ``flat_env``, env 0
    (lying exactly flat: exact ties) slot for slot; the convex pairs by
    check_convex.  Raises AssertionError; returns the largest error of
    each output."""
    want = collision.collide(m, d)
    got = [x.cpu() for x in got[:3]] + [got[3]]
    np.testing.assert_array_equal(got[3], want[3])
    groups, direct = kept_slots(m.geom_type, m.pair_geom1, m.pair_geom2,
                                want[3])
    convex = convex_slots(m, want[3])
    direct &= ~convex
    errs = {}
    for k, field in enumerate(("dist", "pos", "frame")):
        if got[k].shape != want[k].shape:
            raise AssertionError(f"{field}: shape {tuple(got[k].shape)}")
        errs[field] = float((got[k][:, direct] - want[k][:, direct])
                            .abs().max()) if direct.any() else 0.0
    cands = box_candidates(m, d)
    for slots in groups:
        errs["frame"] = max(errs["frame"], float(
            (got[2][:, slots] - want[2][:, slots]).abs().max()))
        assert_kept(got[0][:, slots].numpy(), got[1][:, slots].numpy(),
                    want[0][:, slots].numpy(),
                    *cands[int(want[3][slots[0]])], "kept points")
        if flat_env:
            errs["flat"] = max([errs.get("flat", 0.0)] + [float(
                (got[k][0, slots] - want[k][0, slots]).abs().max())
                for k in range(3)])
    for field, e in errs.items():
        if not e <= 2e-5:
            raise AssertionError(f"kernel E {field}: {e:.3e} beyond 2e-5")
    if convex.any():
        errs.update(check_convex(got, want, m, d, convex))
    return errs


SCENE_PRESS = dict(humanoid=0.3, ant=0.3, cmu=0.2)   # all float at qpos0


def scene(name: str, device="cuda"):
    """(model, press=..., kernels=...): the stage_split arguments of the
    suite humanoid or the CMU humanoid (kernels A and B, CG 6 / 6) or the
    ant (kernels A and C on its Newton Hessians; its Newton solve never
    takes B), compiled from the committed scenes."""
    from vnl_tpu_torch import compat, mjcf
    if name in ("humanoid", "cmu"):
        xml = dict(humanoid=compat.DM_HUMANOID_XML,
                   cmu=compat.CMU_HUMANOID_XML)[name]
        m = mjcf.load_model(xml, overrides=dict(
            solver="cg", iterations=6, ls_iterations=6), device=device)
        return m, dict(press=SCENE_PRESS[name], kernels=("position", "cg"))
    if name == "ant":
        m = mjcf.load_model(compat.GYM_ANT_XML, overrides=dict(
            solver="newton", iterations=1, ls_iterations=4), device=device)
        return m, dict(press=SCENE_PRESS[name],
                       kernels=("position", "sweep"))
    raise ValueError(f"no scene {name!r}")


def stage_split(m, batch: int = 1024, seed: int = 0, press: float = 0.005,
                kernels=("position", "cg", "sweep")) -> dict:
    """Milliseconds per launch of kernels A, B and C with stages left out,
    and their resources, for the model ``m`` on its CUDA device.  Kernel
    B's contact states have the root lowered by ``press`` (the humanoid
    needs 0.3 to touch the floor); ``kernels`` names the ones to time."""
    gen = torch.Generator(device=m.device).manual_seed(seed)
    qpos = random_states(m, batch, gen)
    out = dict(batch=batch)
    if "position" in kernels:
        out["position_ms"] = {
            name: time_ms(lambda: position_ops._launch(m, qpos, skip=skip),
                          queued=QUEUED)
            for name, skip in (("whole", 0), ("no_sweeps", 1),
                               ("no_subtree_sums", 2), ("no_tree_walk", 4),
                               ("no_qM_assembly", 8), ("none_of_them", 15))}
        out["position_resources"] = position_ops.resources(m)
        out["position_route"] = position_ops.route_name(m)
    if "cg" in kernels:
        (args, st), _ = contact_states(m, batch, gen, press)

        def solve(iters, ls_iters, skip=0):
            s = cg_ops.CgStatics.make(st.nv, st.lim_dof, st.chain1,
                                      st.chain2, iters, ls_iters)
            return time_ms(lambda: cg_ops._launch(s, args, skip=skip),
                           queued=QUEUED)

        out["cg_ms"] = {"whole": solve(st.iters, st.ls_iters),
                        "no_line_search": solve(st.iters, 0),
                        "no_iterations": solve(0, st.ls_iters),
                        "no_jv_chains": solve(st.iters, st.ls_iters, 1),
                        "no_jtf_chains": solve(st.iters, st.ls_iters, 2),
                        "no_matvecs": solve(st.iters, st.ls_iters, 4),
                        "none_of_them": solve(st.iters, st.ls_iters, 7)}
        out["cg_resources"] = cg_ops.resources(st, m.device)
        out["cg_shape"] = dict(iters=st.iters, ls_iters=st.ls_iters,
                               nv=st.nv, ncon=st.ncon, nlimit=st.nlimit,
                               route=cg_ops.kernel_name(st))
    if "sweep" in kernels:
        if m.opt.solver == int(SolverType.NEWTON):
            pair, _ = newton_hessians(m, batch, gen, press)
        else:
            pair = twin_pair(m, qpos)
        one = torch.zeros(1, device=m.device)
        out["empty_launch_ms"] = time_ms(lambda: one.add_(1.0),
                                         queued=QUEUED)
        out["sweep_ms"] = {
            name: time_ms(lambda: sweep_ops._launch(pair, skip=skip),
                          queued=QUEUED)
            for name, skip in (("whole", 0), ("no_pivots", 1),
                               ("load_store_only", 3))}
        out["sweep_resources"] = sweep_ops.resources(m.nv)
        out["sweep_shape"] = list(pair.shape)
    return out
