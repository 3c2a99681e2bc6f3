"""Kernels A, B, C and D against their plain PyTorch versions on a CUDA device
(marked ``cuda``; skipped without a card, since a CUDA kernel has no CPU
mode); the renderer and the egocentric camera on the card against the
same code on the CPU; and the trainer under a one-rank NCCL process group
against the same run without a group, bit for bit.  Imports neither JAX
nor vnl_tpu, so it also runs where only the port is installed:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

from vnl_tpu_torch import compat, kernel_bench
from vnl_tpu_torch.ops import cg as cg_ops
from vnl_tpu_torch.ops import constraints as con_ops
from vnl_tpu_torch.ops import launch_counts
from vnl_tpu_torch.ops import position as pos_ops
from vnl_tpu_torch.ops import sweep as sweep_ops
from vnl_tpu_torch.physics import actuation, forward, inertia, solver

B = 64


@pytest.fixture
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return compat.model_from_numpy(compat.TWIN_MODEL, device="cuda")


def _states(m, press=0.0, batch=B):
    gen = torch.Generator(device="cuda").manual_seed(0)
    qpos = m.qpos0.expand(batch, -1).clone()
    qpos[:, 2] -= press
    lo, hi = m.jnt_range[1:, 0], m.jnt_range[1:, 1]
    qpos[:, 7:] = lo + torch.rand(batch, m.nq - 7, generator=gen,
                                  device="cuda") * (hi - lo)
    qvel = 0.5 * torch.randn(batch, m.nv, generator=gen, device="cuda")
    return qpos, qvel


def _free_states(m, batch, spread):
    """qpos0 with a tilted root and hinges within +-spread rad (for the
    small scenes, whose hinges have no range)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    qpos = m.qpos0.expand(batch, -1).clone()
    quat = torch.tensor([1.0, 0, 0, 0], device="cuda") + 0.3 * torch.randn(
        batch, 4, generator=gen, device="cuda")
    qpos[:, 3:7] = quat / quat.norm(dim=-1, keepdim=True)
    qpos[:, 7:] += spread * (2 * torch.rand(batch, m.nq - 7, generator=gen,
                                            device="cuda") - 1)
    return qpos.contiguous()


def _close(got, want, rtol, atol, name):
    err = (got - want).abs()
    assert bool((err <= atol + rtol * want.abs()).all()), (
        name, float(err.max()))


def _check_position(m, qpos):
    """Kernel A against the plain version at the tolerances of
    tests/test_pallas_position.py, one launch counted, and the same bits
    from a second launch."""
    before = launch_counts["position"]
    got = pos_ops.position(m, qpos)
    assert launch_counts["position"] == before + 1
    want = pos_ops.position_plain(m, qpos)
    assert len(got) == len(want) == len(pos_ops.output_shapes(m))
    for name, g, w in zip(pos_ops.OUTPUT_NAMES[:12], got, want):
        _close(g, w, 2e-5, 2e-5, name)
    eye = torch.eye(m.nv, device="cuda")
    hB = torch.diag(m.opt.timestep * m.dof_damping)
    for name, g, w, A in zip(pos_ops.OUTPUT_NAMES[12:], got[12:], want[12:],
                             (got[11], got[11] + hB)):
        _close(g, w, 5e-3, 1e-4 * float(w.abs().max()), name)
        assert float((A @ g - eye).abs().max()) < 5e-3, name
    again = pos_ops.position(m, qpos)
    for name, g, a in zip(pos_ops.OUTPUT_NAMES, got, again):
        assert torch.equal(g, a), name


def _cg_args(m, qpos, qvel):
    """Kernel B's inputs on make_constraints' system (kernel D's differs
    from it by a rounding; kernel_bench._solve_inputs says why)."""
    from vnl_tpu_torch.physics import collision, constraint
    batch = qpos.shape[0]
    d = forward.make_data(m, batch, qpos=qpos, qvel=qvel)
    d, _ = forward.fwd_position(m, d)
    efc = constraint.make_constraints(m, d, d.contact_dist, d.contact_pos,
                                      d.contact_frame,
                                      collision.pair_expansion(m))
    d = forward.fwd_velocity(m, d)
    _, qfrc_act, _ = actuation.actuation(m, d)
    qacc_smooth = inertia.solve_m(d, d.qfrc_passive - d.qfrc_bias + qfrc_act)
    active = int((d.contact_dist < 0).sum())
    return solver.cg_inputs(m, d, efc, qacc_smooth,
                            max(m.opt.iterations, 1)), active


def _check_cg(args, st, large_batch=False):
    """Kernel B against the plain version at rtol = atol = 1e-3
    (tests/test_pallas_cg.py), one launch counted, and the same bits from a
    second launch.  ``large_batch``: through kernel_bench.check_cg, which
    holds an env that misses the float32 plain result (at most 0.5% of the
    batch) to the plain version run in float64, at the same tolerance."""
    before = launch_counts["cg"]
    got = cg_ops.cg(*args, statics=st)
    assert launch_counts["cg"] == before + 1
    if large_batch:
        kernel_bench.check_cg(st, args, got)
    else:
        want = cg_ops.cg_plain(*args, statics=st)
        for name, g, w in zip(("qacc", "qfrc_constraint", "con_f"), got,
                              want):
            _close(g, w, 1e-3, 1e-3, name)
    again = cg_ops.cg(*args, statics=st)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_position_kernel_matches_plain(model):
    _check_position(model, _states(model)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [3, 1000])
def test_position_kernel_batch_sizes(model, batch):
    _check_position(model, _states(model, batch=batch)[0])


@pytest.mark.cuda
def test_position_kernel_undamped_twin(model):
    """No damping: one matrix is swept and 13 outputs come back."""
    m = dataclasses.replace(model, cache={},
                            dof_damping=torch.zeros_like(model.dof_damping))
    assert not inertia.needs_implicit_damping(m)
    _check_position(m, _states(m)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["box_chain", "star96"])
def test_position_kernel_small_and_widest_model(model, scene):
    """nv = 7 (the smallest register tile, damped) and nv = 96 (the widest
    one, undamped); the twin's nv = 73 takes the third."""
    path = {"box_chain": compat.BOX_CHAIN_MODEL,
            "star96": compat.STAR96_MODEL}[scene]
    m = compat.model_from_numpy(path, device="cuda")
    assert m.nv == {"box_chain": 7, "star96": 96}[scene]
    _check_position(m, _free_states(m, 5, 0.5))


@pytest.mark.cuda
def test_position_kernel_rejects_wider_models(model):
    wide = dataclasses.replace(model, nv=97, cache={})
    with pytest.raises(ValueError):
        pos_ops.position(wide, _states(model)[0])


@pytest.mark.cuda
def test_cg_kernel_matches_plain(model):
    (args, st), active = _cg_args(model, *_states(model, press=0.005))
    assert active > 0
    _check_cg(args, st)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [3, 1000])
def test_cg_kernel_batch_sizes(model, batch):
    (args, st), _ = _cg_args(model, *_states(model, press=0.005,
                                             batch=batch))
    _check_cg(args, st, large_batch=batch > 64)


@pytest.mark.cuda
def test_cg_kernel_small_scene(model):
    """nv = 7: a ball with a limited hinged arm pressed into a plane (three
    contacts, one limit row beyond its range)."""
    m = compat.model_from_numpy(compat.BALL_ARM_MODEL, device="cuda")
    qpos = m.qpos0.expand(5, -1).clone()
    qpos[:, 2] = 0.045
    qpos[:, 7:] += 0.35
    gen = torch.Generator(device="cuda").manual_seed(3)
    qvel = 0.2 * torch.randn(5, m.nv, generator=gen, device="cuda")
    (args, st), active = _cg_args(m, qpos.contiguous(), qvel)
    assert active > 0 and (st.nv, st.ncon, st.nlimit) == (7, 3, 1)
    _check_cg(args, st)


def _padded(model, pad, batch=B):
    """The twin's contact system with ``pad`` more contacts (copies of its
    first ones) that stay inactive, so its solve is the twin's: (args,
    statics, the twin's own solve)."""
    (args, st), _ = _cg_args(model, *_states(model, press=0.005,
                                             batch=batch))
    narrow = cg_ops.cg(*args, statics=st)
    return (*kernel_bench.padded_contacts(args, st, pad), narrow)


@pytest.mark.cuda
def test_cg_kernel_wide_system(model):
    """More than 160 constraint rows (the wide route, one contact row a
    thread): the twin's system with three more contacts that stay
    inactive, so the solve is that of the test above."""
    args, wide, narrow = _padded(model, 3)
    assert cg_ops.kernel_name(wide) == "cg_wide_kernel<1,1>"
    _check_cg(args, wide)
    got = cg_ops.cg(*args, statics=wide)
    assert bool((got[2][:, wide.ncon - 3:] == 0).all())
    _close(got[0], narrow[0], 1e-3, 1e-3, "qacc against the narrow system")


@pytest.mark.cuda
def test_cg_kernel_wide_route_reruns(model):
    """The wide route just above 160 rows (171) on 1000 envs, held by
    kernel_bench.check_cg_reruns as the humanoid's 729 rows are."""
    args, wide, _ = _padded(model, 3, batch=1000)
    got = cg_ops.cg(*args, statics=wide)
    kernel_bench.check_cg_reruns(wide, args, got)
    for g, a in zip(got, cg_ops.cg(*args, statics=wide)):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_cg_kernel_widest_system(model):
    """More than 1,024 contact rows (the line search from shared memory,
    cg_kernel<0>): the twin's system with 240 inactive contacts more; its
    launches are also counted on their own."""
    args, wide, narrow = _padded(model, 240)
    assert cg_ops.kernel_name(wide) == "cg_kernel<0>"
    _check_cg(args, wide)
    before = launch_counts["cg"], launch_counts["cg_widest"]
    got = cg_ops.cg(*args, statics=wide)
    assert (launch_counts["cg"], launch_counts["cg_widest"]) == \
        (before[0] + 1, before[1] + 1)
    _close(got[0], narrow[0], 1e-3, 1e-3, "qacc against the narrow system")


def _check_constraints(m, batch, press=0.005, edges=False, seed=0):
    """Kernel D against make_constraints -> cg_inputs' packing on the card:
    every output within rtol 1e-5 and atol 1e-5 of its largest entry
    (float32 rounding: the kernel sums a chain and a G row in an order of
    its own), one launch counted, and the same bits from a second launch.
    Returns the kernel's outputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, dist, cpos, frame, pair = kernel_bench.constraint_states(
        m, batch, gen, press, edges)
    before = launch_counts["constraints"]
    got = con_ops.constraints(m, d, dist, cpos, frame, pair)
    assert launch_counts["constraints"] == before + 1
    want = con_ops.constraints_plain(m, d, dist, cpos, frame, pair)
    for name, g, w in zip(con_ops.OUTPUT_NAMES, got, want):
        assert g.shape == w.shape, name
        _close(g, w, 1e-5, 1e-5 * float(w.abs().max()), name)
    again = con_ops.constraints(m, d, dist, cpos, frame, pair)
    for name, g, a in zip(con_ops.OUTPUT_NAMES, got, again):
        assert torch.equal(g, a), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 128, 1024])
def test_constraints_kernel_matches_plain(model, batch):
    _check_constraints(model, batch)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["twin", "direct_solref_margin_gap"])
def test_constraints_kernel_edges(model, variant):
    """Contacts near, at and past margin - gap and limit rows on both sides
    of their ranges (both branches of the impedance sigmoid and the
    inactive one); on the variant, half the contacts and limits in _kb's
    direct format and margin 2e-3, gap 5e-4."""
    m = model
    if variant != "twin":
        pref, jref = m.pair_solref.clone(), m.jnt_solref.clone()
        pref[::2] = torch.tensor([-5000.0, -30.0], device="cuda")
        jref[::2] = torch.tensor([-2000.0, -20.0], device="cuda")
        m = dataclasses.replace(
            m, cache={}, pair_solref=pref, jnt_solref=jref,
            pair_margin=torch.full_like(m.pair_margin, 2e-3),
            pair_gap=torch.full_like(m.pair_gap, 5e-4))
    _check_constraints(m, 128, edges=True, seed=1)


@pytest.mark.cuda
def test_constraints_kernel_humanoid(humanoid):
    """ncon 177 (two trips of the block over the contact slots), condim 1
    and 3, contacts between two moving bodies."""
    _check_constraints(humanoid, 256, press=0.3, seed=2)
    _check_constraints(humanoid, 256, press=0.3, edges=True, seed=3)


@pytest.mark.cuda
def test_constraints_kernel_contact_only(model):
    """No limit: the kernel writes kernel B's inert row (sign 0, D 0); the
    box chain solved by CG."""
    from vnl_tpu_torch.physics.model import SolverType
    m = compat.model_from_numpy(compat.BOX_CHAIN_MODEL, device="cuda")
    m = dataclasses.replace(m, cache={}, opt=dataclasses.replace(
        m.opt, solver=int(SolverType.CG)))
    got = _check_constraints(m, 5, press=0.0, edges=True)
    for row in got[1:5]:
        assert row.shape == (5, 1) and not bool(row.any())


@pytest.mark.cuda
def test_constraints_launches_a_control_step(model, ant):
    """Kernel D runs once a substep where kernel B solves: n_frames times a
    twin control step; never on the ant (Newton)."""
    from vnl_tpu_torch.envs import AntTracking, make_twin_env
    for env, want in ((make_twin_env(device="cuda"), 5),
                      (AntTracking(device="cuda"), 0)):
        assert env.n_frames == 5
        state = env.reset(B, generator=torch.Generator(
            device="cuda").manual_seed(6))
        launch_counts.clear()
        state = env.step(state, torch.zeros(B, env.action_size,
                                            device="cuda"))
        assert launch_counts["constraints"] == want
        assert bool(torch.isfinite(state.pipeline_state.qpos).all())


# the one-warp route (n = 1, 14, 16 on T = 16; 17, 27, 29, 32 on T = 32),
# every register tile (64, 73, 96) and the shared-memory route (97, 120),
# odd and even matrix counts, and the twin's stacked pair
SWEEP_CASES = [(n, count) for n in (1, 14, 16, 17, 27, 29, 32, 64, 73, 96,
                                    97, 120)
               for count in (3, 12, 2048)] + [("twin", B)]


def _spd(count, n):
    """SPD matrices with uneven row scales, made as the JAX package's sweep
    test makes them (tests/test_pallas_ops.py _spd_batch)."""
    gen = torch.Generator(device="cuda").manual_seed(n * 10_000 + count)
    scale = 0.05 + 1.95 * torch.rand(count, 1, n, generator=gen,
                                     device="cuda")
    L = torch.randn(count, n, n, generator=gen, device="cuda") * scale
    a = L @ L.transpose(1, 2) + 0.5 * torch.eye(n, device="cuda")
    return (0.5 * (a + a.transpose(1, 2))).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n,count", SWEEP_CASES)
def test_sweep_kernel_matches_plain(model, n, count):
    """Kernel C on its route for n: the plain version at rtol 5e-3 / atol
    1e-4 of the inverse's scale, |A X - I| < 5e-3, a bitwise symmetric
    output, one launch per call and the same bits from two launches."""
    if n == "twin":                     # [qM, qM + h diag(B)], (B, 2, 73, 73)
        qpos, _ = _states(model)
        qM = pos_ops.position(model, qpos)[11]
        hB = torch.diag(model.opt.timestep * model.dof_damping)
        a = torch.stack([qM, qM + hB], 1)
    else:
        a = _spd(count, n)
    route = sweep_ops.route(a.shape[-1])
    want = sweep_ops.inv_spd_sweep_plain(a)
    eye = torch.eye(a.shape[-1], device="cuda")
    before = launch_counts["sweep"]
    got = sweep_ops.inv_spd_sweep(a)
    assert launch_counts["sweep"] == before + 1
    assert torch.equal(got, sweep_ops.inv_spd_sweep(a))
    _close(got, want, 5e-3, 1e-4 * float(want.abs().max()),
           f"inverse, {route}")
    assert float((a @ got - eye).abs().max()) < 5e-3
    assert torch.equal(got, got.transpose(-1, -2))


@pytest.mark.cuda
def test_unfused_step_launches_kernel_c(model):
    """One control step of the unfused stage: kernel C once, kernels E, D
    and B on every substep, kernel A never."""
    from vnl_tpu_torch.envs.base import PipelineEnv
    qpos, qvel = _states(model, press=0.005)
    env = PipelineEnv(model, n_frames=5, fused_position=False)
    launch_counts.clear()
    d = env.pipeline_init(qpos, qvel)
    assert dict(launch_counts) == {"sweep": 1, "collision": 1,
                                   "constraints": 1, "cg": 1}
    d = env.pipeline_step(d, torch.zeros(B, model.nu, device="cuda"))
    assert dict(launch_counts) == {"sweep": 2, "collision": 6,
                                   "constraints": 6, "cg": 6}
    assert bool(torch.isfinite(d.qpos).all())


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(model):
    with pytest.raises(ValueError):
        pos_ops.position(model, torch.zeros(4, model.nq, device="cuda",
                                            dtype=torch.float64))
    with pytest.raises(ValueError):
        pos_ops.position(model, torch.zeros(4, model.nq + 1, device="cuda"))
    with pytest.raises(ValueError):
        sweep_ops.inv_spd_sweep(torch.zeros(4, 5, 6, device="cuda"))
    with pytest.raises(ValueError):
        sweep_ops.inv_spd_sweep(torch.zeros(4, 5, 5, device="cuda",
                                            dtype=torch.float64))
    with pytest.raises(ValueError):     # one matrix must fit shared memory
        sweep_ops.inv_spd_sweep(torch.zeros(1, 300, 300, device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    d, dist, cpos, frame, pair = kernel_bench.constraint_states(model, 4,
                                                                gen)
    with pytest.raises(ValueError, match="qvel"):
        con_ops.constraints(model, d.replace(qvel=d.qvel.double()), dist,
                            cpos, frame, pair)
    with pytest.raises(ValueError, match="con_frame"):
        con_ops.constraints(model, d, dist, cpos, frame[:, :-1], pair)
    with pytest.raises(ValueError, match="con_dist"):
        con_ops.constraints(model, d, dist.cpu(), cpos, frame, pair)


# ---- the humanoid and ant families (committed third-party scenes) ----

def _scene(path, **overrides):
    from vnl_tpu_torch import mjcf
    return mjcf.load_model(path, overrides=overrides or None, device="cuda")


@pytest.fixture
def humanoid(model):
    return _scene(compat.DM_HUMANOID_XML, solver="cg", iterations=6,
                  ls_iterations=6)


@pytest.fixture
def ant(model):
    return _scene(compat.GYM_ANT_XML, solver="newton", iterations=1,
                  ls_iterations=4)


@pytest.mark.cuda
def test_position_kernel_humanoid_and_ant(humanoid, ant):
    """Kernel A at nv 27 and nv 14, on the one-warp route (32 and 16 rows a
    lane)."""
    for m, tile in ((humanoid, (32, 1)), (ant, (16, 1))):
        assert pos_ops.tile_shape(m.nv) == tile
        _check_position(m, _free_states(m, B, 0.5))


def chain_xml(hinges: int) -> str:
    """A free-floating chain of capsules with ``hinges`` damped hinges
    (nv = 6 + hinges), for kernel A's widths.  Armature 1 keeps qM's
    condition in the hundreds: with 0.05, a chain of 26 hinges (condition
    about 5e3) is where the plain version's recursive Schur complements,
    the yardstick, miss the inverses' tolerance against float64 by
    themselves."""
    body = ""
    for i in reversed(range(hinges)):
        axis = ("0 1 0", "1 0 0", "0 0 1")[i % 3]
        body = (f'<body pos="0 0 -0.12"><joint type="hinge" axis="{axis}" '
                f'damping="0.5" armature="1"/><geom type="capsule" '
                f'size="0.04" fromto="0 0 0 0 0 -0.1" mass="0.5"/>{body}'
                '</body>')
    return ('<mujoco><option timestep="0.005"/><worldbody>'
            '<geom type="plane" size="5 5 0.1"/>'
            '<body pos="0 0 2"><freejoint/><geom type="sphere" size="0.1" '
            f'mass="1"/>{body}</body></worldbody></mujoco>')


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [8, 14, 27, 32])
def test_position_kernel_warp_route(model, nv):
    """Kernel A on the one-warp route at nv 8, 14, 27 and 32 (chains of
    capsules), against the plain version, two launches the same bits."""
    from vnl_tpu_torch import mjcf
    m = mjcf.load_model(chain_xml(nv - 6), device="cuda")
    assert m.nv == nv and inertia.needs_implicit_damping(m)
    assert pos_ops.tile_warps(*pos_ops.tile_shape(nv)) == 1
    _check_position(m, _free_states(m, B, 0.8))


@pytest.mark.cuda
def test_cg_kernel_humanoid(humanoid):
    """Kernel B on humanoid contact states: 729 constraint rows (the wide
    route, three contact rows a thread), condim 1 and 3, contacts
    between two moving bodies.  Held as chip_smoke.py holds it, by
    kernel_bench.check_cg_reruns: check_cg's per-env tolerance with a
    budget of twice the envs the plain solve itself misses when re-run at
    one rounding (no float32 evaluation meets check_cg's rule here)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    (args, st), active = kernel_bench.contact_states(humanoid, 256, gen,
                                                     press=0.3)
    assert cg_ops.kernel_name(st) == "cg_wide_kernel<3,1>" and active > 0
    assert st.nlimit + 4 * st.ncon == 21 + 4 * 177
    before = launch_counts["cg"]
    got = cg_ops.cg(*args, statics=st)
    assert launch_counts["cg"] == before + 1
    kernel_bench.check_cg_reruns(st, args, got)
    for g, a in zip(got, cg_ops.cg(*args, statics=st)):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_sweep_kernel_ant_newton_hessians(ant):
    """Kernel C at n 14 on the ant's Newton Hessians, rtol 5e-3."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    H, active = kernel_bench.newton_hessians(ant, 256, gen, press=0.3)
    assert active > 0 and H.shape == (256, 14, 14)
    got = sweep_ops.inv_spd_sweep(H)
    want = sweep_ops.inv_spd_sweep_plain(H)
    _close(got, want, 5e-3, 1e-4 * float(want.abs().max()), "inverse")
    assert float((H @ got - torch.eye(14, device="cuda")).abs().max()) < 5e-3


@pytest.mark.cuda
def test_ant_step_launches(ant):
    """One RK4 physics step of the ant: four forward passes, each kernel
    A, E and C once each (C: Newton's H^-1, one iteration), B never."""
    qpos = _free_states(ant, B, 0.3)
    qpos[:, 2] -= 0.3
    d = forward.make_data(ant, B, qpos=qpos)
    launch_counts.clear()
    d = forward.step(ant, d)
    assert dict(launch_counts) == {"position": 4, "collision": 4,
                                   "sweep": 4}
    assert bool(torch.isfinite(d.qpos).all())


# ---- rendering and data parallelism ----

def _twin_data(m, batch, seed):
    from vnl_tpu_torch.physics import kinematics
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qpos = kernel_bench.random_states(m, batch, gen)
    return kinematics.kinematics(m, forward.make_data(m, batch, qpos))


@pytest.mark.cuda
def test_overlay_frames_card_against_cpu(model):
    """The twin's agent-vs-ghost overlay at 320 x 240 on the card and on
    the CPU: at most 0.5% of the pixels more than one level apart (the
    CPU parity tests' tolerance)."""
    from vnl_tpu_torch.render.software import overlay_frames
    q = _twin_data(model, 6, 3).qpos.double().cpu().numpy()
    ghost = q.copy()
    ghost[:, :3] += np.array([0.04, -0.03, 0.0])
    card = overlay_frames(model, q, ghost)
    assert card.device.type == "cuda" and card.shape == (6, 240, 320, 3)
    cpu = overlay_frames(model, q, ghost, device="cpu")
    off = (card.cpu().int() - cpu.int()).abs().amax(-1) > 1
    assert float(off.float().mean()) <= 0.005


@pytest.mark.cuda
def test_egocentric_camera_card_against_cpu(model):
    """make_egocentric_camera at 256 envs on the card, 8 of them on the
    CPU: within 1e-4 on at least 99.5% of the pixels."""
    from vnl_tpu_torch.render import make_egocentric_camera
    d = _twin_data(model, 256, 4)
    img = make_egocentric_camera(model)(d)
    assert img.shape == (256, 64, 64, 3) and img.device.type == "cuda"
    m_cpu = compat.model_from_numpy(compat.TWIN_MODEL, device="cpu")
    d8 = d.replace(**{f: getattr(d, f)[:8].cpu() for f in (
        "xpos", "xmat", "geom_xpos", "geom_xmat")})
    want = make_egocentric_camera(m_cpu)(d8)
    within = ((img[:8].cpu() - want).abs() <= 1e-4).all(-1)
    assert float(within.float().mean()) >= 0.995


@pytest.mark.cuda
def test_one_rank_nccl_training_is_the_plain_run(model):
    """train(num_devices=1) under a one-rank NCCL group (the gradients,
    the normaliser and the metrics through all-reduces) gives the params
    of the same run without a group, bit for bit."""
    import functools
    import socket

    import torch.distributed as dist

    from vnl_tpu_torch import models
    from vnl_tpu_torch.envs import make_twin_env
    from vnl_tpu_torch.training import train
    factory = functools.partial(
        models.make_intention_ppo_networks, intention_latent_size=8,
        encoder_layer_sizes=(64,), decoder_layer_sizes=(64,),
        value_hidden_layer_sizes=(64,))

    def run(**extra):
        _, (norm, policy), _ = train(
            make_twin_env(device="cuda"), num_timesteps=2 * 4 * 8 * 4,
            episode_length=10, num_envs=32, num_eval_envs=4,
            unroll_length=8, batch_size=8, num_minibatches=4,
            num_updates_per_batch=2, num_evals=1,
            normalize_observations=True, network_factory=factory,
            device="cuda", **extra)
        out = {k: v.cpu() for k, v in policy.items()}
        out.update({k: getattr(norm, k).cpu() for k in (
            "count", "mean", "summed_variance", "std")})
        return out

    plain = run()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        grouped = run(num_devices=1)
    finally:
        dist.destroy_process_group()
    assert sorted(plain) == sorted(grouped)
    for k in plain:
        assert plain[k].numpy().tobytes() == grouped[k].numpy().tobytes(), k


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def _assert_nests_equal(got, want):
    from vnl_tpu_torch.utils import graphs
    got, want = list(graphs.named_leaves(got)), list(graphs.named_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(_bits(g), _bits(w)), path


@pytest.mark.cuda
def test_control_step_graph_is_the_eager_step(model):
    """Four control steps of the twin (wrapped for training, keeper policy
    sampling) replayed as the control-step graph against the same steps
    eagerly, from the same seed: the final state and every transition
    bit for bit, and the same launch counts."""
    from vnl_tpu_torch.envs import make_twin_env, wrap_for_training
    from vnl_tpu_torch.models import make_inference_fn
    from vnl_tpu_torch.training import ActorStepGraph, generate_unroll
    from vnl_tpu_torch.utils import graphs
    env = wrap_for_training(make_twin_env(device="cuda"), episode_length=3)
    policy = make_inference_fn(compat.policy_from_numpy(
        compat.KEEPER_POLICY, device="cuda"))(deterministic=False)
    runs = []
    for graphed in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(4)
        state = env.reset(B, generator=gen)
        step = ActorStepGraph(env, policy, gen, ("truncation", "traj")) \
            if graphed else None
        launch_counts.clear()
        state, roll = generate_unroll(env, state, policy, gen, 4,
                                      ("truncation", "traj"), step=step)
        runs.append((graphs.clone(state), roll, dict(launch_counts)))
    _assert_nests_equal(runs[1][:2], runs[0][:2])
    assert runs[1][2] == runs[0][2] and runs[0][2]["position"] == 20
    assert runs[0][2]["constraints"] == runs[0][2]["collision"] == 20


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["twin", "humanoid"])
def test_control_step_graph_parts_add_up_to_its_nodes(model, body):
    """The control-step graph's capture report: the nodes of the eight
    tagged parts (utils/profiler.py ``part``) add up to the graph's node
    count, every part adds some, and a replay counts each part's nodes
    under ``graph_nodes.<part>`` in an open recording."""
    from vnl_tpu_torch import models
    from vnl_tpu_torch.envs import (HumanoidTracking, make_twin_env,
                                    wrap_for_training)
    from vnl_tpu_torch.training import ActorStepGraph
    from vnl_tpu_torch.utils import profiler
    raw = make_twin_env(device="cuda") if body == "twin" else \
        HumanoidTracking(device="cuda")
    env = wrap_for_training(raw, episode_length=3)
    gen = torch.Generator(device="cuda").manual_seed(8)
    state = env.reset(B, generator=gen)
    net = models.make_intention_ppo_networks(
        state.info["traj"].shape[-1], state.obs.shape[-1], env.action_size,
        intention_latent_size=8, encoder_layer_sizes=(64,),
        decoder_layer_sizes=(64,), value_hidden_layer_sizes=(64,),
        generator=torch.Generator().manual_seed(9), device="cuda")
    policy = models.make_inference_fn(net)(deterministic=False)
    step = ActorStepGraph(env, policy, gen, ("truncation", "traj"))
    state, _ = step(state)
    parts = step.report["parts"]
    assert set(parts) == {"position", "collision", "constraints",
                          "velocity", "solve", "integrate", "env", "policy"}
    assert all(n > 0 for n in parts.values()), parts
    assert sum(parts.values()) == step.report["nodes"], parts
    with profiler.recording("cuda") as rec:
        with profiler.timed("train.step", step=0):
            step(state)
    counters = rec.summary([0])["counters"]
    assert counters["graph_nodes"] == [step.report["nodes"]]
    for p, n in parts.items():
        assert counters[f"graph_nodes.{p}"] == [n], p


@pytest.mark.cuda
def test_sgd_update_graph_is_the_eager_update(model):
    """Three PPO updates on minibatches of a twin rollout, replayed as the
    SGD-update graph against the eager updates, from the same weights and
    generator seed: losses, stats and parameters bit for bit."""
    import functools

    from vnl_tpu_torch import models
    from vnl_tpu_torch.envs import make_twin_env, wrap_for_training
    from vnl_tpu_torch.training import (compute_ppo_intention_loss,
                                        gradients)
    from vnl_tpu_torch.training.acting import tree_map
    from vnl_tpu_torch.training.train import collect_rollouts
    env = wrap_for_training(make_twin_env(device="cuda"), episode_length=8)
    gen = torch.Generator(device="cuda").manual_seed(5)
    state = env.reset(B, generator=gen)

    def make_net():
        return models.make_intention_ppo_networks(
            state.info["traj"].shape[-1], state.obs.shape[-1],
            env.action_size, intention_latent_size=8,
            encoder_layer_sizes=(64,), decoder_layer_sizes=(64,),
            value_hidden_layer_sizes=(64,),
            generator=torch.Generator().manual_seed(6), device="cuda")

    policy = models.make_inference_fn(make_net())(deterministic=False)
    _, batch = collect_rollouts(env, state, policy, gen, 5, 1)
    runs = []
    for graphed in (False, True):
        net = make_net()
        loss_gen = torch.Generator(device="cuda").manual_seed(7)
        update = gradients.gradient_update_fn(
            functools.partial(compute_ppo_intention_loss, net,
                              generator=loss_gen),
            gradients.make_adam(net.parameters(), 1e-3), has_aux=True,
            cuda_graph=graphed, generators=(loss_gen,))
        out = [update(tree_map(lambda x: x[16 * k:16 * k + 16], batch))
               for k in range(3)]
        runs.append(([(loss.detach(), stats) for loss, stats in out],
                     net.state_dict()))
    _assert_nests_equal(runs[1], runs[0])


@pytest.mark.cuda
def test_recording_on_the_card(model):
    """A graphed training run of the twin inside ``profiler.recording``
    against the same run outside it: the same parameters bit for bit.  Its
    last three steps: the same graph nodes a step, every control step and
    update a device span with device time, each device interval beginning
    no earlier than its host interval, busy and idle adding up to the
    window; the anchor's error under 0.1 ms.  A device span around a spin
    of about 2 ms reads it."""
    import functools

    from vnl_tpu_torch import models
    from vnl_tpu_torch.envs import make_twin_env
    from vnl_tpu_torch.training import train
    from vnl_tpu_torch.utils import profiler
    factory = functools.partial(
        models.make_intention_ppo_networks, intention_latent_size=8,
        encoder_layer_sizes=(64,), decoder_layer_sizes=(64,),
        value_hidden_layer_sizes=(64,))

    def run():
        _, (_, policy), _ = train(
            make_twin_env(device="cuda"), num_timesteps=4 * 8 * 8 * 4,
            episode_length=10, num_envs=32, num_eval_envs=4,
            unroll_length=8, batch_size=8, num_minibatches=4,
            num_updates_per_batch=2, num_evals=1,
            normalize_observations=True, network_factory=factory,
            device="cuda")
        return {k: v.cpu() for k, v in policy.items()}

    plain = run()
    with profiler.recording("cuda") as rec:
        recorded = run()
    for k in plain:
        assert plain[k].numpy().tobytes() == recorded[k].numpy().tobytes(), k
    # step 0 captures; the evaluation after step 3 replays its own graph
    out = rec.summary([1, 2])
    nodes = out["counters"]["graph_nodes"]
    assert nodes[0] > 0 and nodes == [nodes[0]] * 2
    by_span = out["by_span"]
    assert by_span["rollout.control_step"]["count"] == 8
    assert by_span["sgd.update"]["count"] == 8
    assert by_span["rollout.control_step"]["device_s"] > 0
    assert by_span["sgd.update"]["device_s"] > 0
    assert out["busy_s"] + out["idle_s"] == pytest.approx(out["window_s"])
    assert 0 <= out["idle_s"] < out["window_s"]
    for s in rec.spans:
        if s.device_start_ns is not None:
            assert s.device_start_ns >= s.start_ns - 50_000, s.name
            assert s.device_end_ns >= s.device_start_ns, s.name
    assert abs(rec.clock_error_ns) < 100_000

    with profiler.recording("cuda") as rec:
        with profiler.timed("train.step", step=0):
            with profiler.span("spin", device=True) as spin:
                torch.cuda._sleep(4_000_000)
            torch.cuda.synchronize()
    assert 1e-3 < spin.device_seconds < 0.1
    assert spin.device_end_ns > spin.end_ns
