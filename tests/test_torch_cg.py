"""Kernel B's plain version (vnl_tpu_torch.ops.cg.cg_plain) against
vnl_tpu/physics/solver.py:215 _make_cg_reference, on rodent-twin states
pressed into the floor (setup of tests/test_pallas_cg.py:31-45) and on the
contact-only box with nlimit == 0 (:127-162); plus the port's collision and
constraint assembly against the JAX package's flat solver inputs.
Tolerance 1e-3 (tests/test_pallas_cg.py:120-124)."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu_torch.ops import cg as tcg
from vnl_tpu_torch.physics import actuation as tact
from vnl_tpu_torch.physics import collision as tcol
from vnl_tpu_torch.physics import constraint as tcon
from vnl_tpu_torch.physics import forward as tfwd
from vnl_tpu_torch.physics import inertia as tinertia

import torch_parity as tp

smod = tp.jax_module("vnl_tpu.physics.solver")
nmod = tp.jax_module("vnl_tpu.physics.constraint")
cmod = tp.jax_module("vnl_tpu.physics.collision")
B = 4
OUT = ("qacc", "qfrc_constraint", "con_f")


def _flat_args(m, d0):
    """Per-env flat CG inputs, as tests/test_pallas_cg.py:75 builds them."""
    dist, pos, frame, pair = cmod.collide(m, d0)
    efc = nmod.make_constraints(m, d0, dist, pos, frame, pair,
                                materialize_jc=False)
    g36 = jnp.concatenate([
        efc.con_G2.transpose(1, 2, 0).reshape(18, efc.ncon),
        efc.con_G1.transpose(1, 2, 0).reshape(18, efc.ncon)], axis=0)
    return efc, (d0.qM, d0.qMinv, d0.qacc_smooth, efc.con_cdof, g36,
                 efc.lim_sign, efc.lim_aref, efc.lim_D, efc.con_mu,
                 efc.con_aref, efc.con_D)


def _batched(m, d, n):
    per_env = [_flat_args(m, jax.tree.map(lambda x: x[i], d)) for i in range(n)]
    efc = per_env[0][0]
    args = tuple(np.stack([np.asarray(a[1][j]) for a in per_env])
                 for j in range(len(per_env[0][1])))
    return efc, args


@pytest.fixture(scope="module")
def twin():
    jm = tp.jax_twin()
    qpos, qvel = tp.perturbed_states(jm, B, seed=1, press=0.005)
    d = tp.jax_forward(jm, qpos, qvel)
    efc, args = _batched(jm, d, B)
    return jm, d, efc, args, qpos, qvel


def _reference(jm, efc, args, n_iter, ls_iters):
    ref = smod._make_cg_reference(jm.nv, efc.ncon, efc.nlimit, n_iter,
                                  ls_iters, np.asarray(efc.lim_dof),
                                  efc.con_chain1, efc.con_chain2)
    return jax.jit(jax.vmap(ref))(*map(jnp.asarray, args))


def _statics(jm, efc, n_iter, ls_iters):
    return tcg.CgStatics.make(jm.nv, np.asarray(efc.lim_dof),
                              efc.con_chain1, efc.con_chain2, n_iter,
                              ls_iters)


def test_plain_matches_reference_twin(twin):
    jm, _, efc, args, _, _ = twin
    assert efc.ncon > 0 and efc.nlimit == 67
    want = _reference(jm, efc, args, 6, 6)
    got = tcg.cg_plain(*map(tp.to_torch, args),
                       statics=_statics(jm, efc, 6, 6))
    for name, g, w in zip(OUT, got, want):
        tp.assert_close(g, w, 1e-3, 1e-3, name)


@pytest.mark.parametrize("inert_row", [False, True])
def test_plain_matches_reference_contact_only_box(inert_row):
    """nlimit == 0: solved as is, and with the inert limit row (sign 0,
    D 0) that the port adds before kernel B."""
    from vnl_tpu import mjcf, physics
    jm = mjcf.load_model(tp.CONTACT_BOX)
    d = jax.vmap(lambda _: physics.forward(jm, physics.make_data(jm)))(
        jnp.arange(1))
    efc, args = _batched(jm, d, 1)
    assert efc.nlimit == 0 and efc.ncon > 0
    n_iter, ls = jm.opt.iterations, jm.opt.ls_iterations
    want = _reference(jm, efc, args, n_iter, ls)
    args = list(map(tp.to_torch, args))
    lim_dof = np.zeros(0, np.int32)
    if inert_row:
        lim_dof = np.zeros(1, np.int32)
        args[5:8] = [torch.zeros(1, 1)] * 3
    st = tcg.CgStatics.make(jm.nv, lim_dof, efc.con_chain1, efc.con_chain2,
                            n_iter, ls)
    got = tcg.cg_plain(*args, statics=st)
    for name, g, w in zip(OUT, got, want):
        tp.assert_close(g, w, 1e-3, 1e-3, name)


def test_constraint_inputs_match(twin):
    """collide + make_constraints + the kernel-B argument packing of the
    port against the JAX package's flat inputs on the same states."""
    jm, _, efc, args, qpos, qvel = twin
    tm = tp.torch_model(jm)
    td = tfwd.make_data(tm, B, qpos=torch.as_tensor(qpos),
                        qvel=torch.as_tensor(qvel))
    td, tefc = tfwd.fwd_position(tm, td)
    np.testing.assert_array_equal(tcol.pair_expansion(tm),
                                  cmod.pair_expansion(jm))
    td = tfwd.fwd_velocity(tm, td)
    _, qfrc_act, _ = tact.actuation(tm, td)
    qacc_smooth = tinertia.solve_m(td, td.qfrc_passive - td.qfrc_bias
                                   + qfrc_act)
    got, st = tcg.cg_inputs(tm, td, tefc, qacc_smooth, 6)
    names = ("qM", "qMinv", "qacc_smooth", "cdof", "g36", "lim_sign",
             "lim_aref", "lim_D", "con_mu", "con_aref", "con_D")
    for name, g, w in zip(names, got, args):
        scale = np.abs(w).max()
        rtol = 5e-3 if name in ("qMinv", "qacc_smooth") else 1e-4
        tp.assert_close(g, w, rtol, 1e-4 * max(scale, 1.0), name)
    np.testing.assert_array_equal(st.chain1, efc.con_chain1)
    np.testing.assert_array_equal(st.chain2, efc.con_chain2)
    np.testing.assert_array_equal(st.lim_dof, np.asarray(efc.lim_dof))


def test_factored_products_match_dense(twin):
    """J x and J^T f of the port's factored system against the JAX
    package's dense contact Jacobian (tests/test_pallas_cg.py:52)."""
    jm, d, efc, args, _, _ = twin
    d0 = jax.tree.map(lambda x: x[0], d)
    dist, pos, frame, pair = cmod.collide(jm, d0)
    efc_d = nmod.make_constraints(jm, d0, dist, pos, frame, pair,
                                  materialize_jc=True)
    a = [tp.to_torch(x[:1]) for x in args]
    st = tcg.CgStatics.make(jm.nv, np.asarray(efc.lim_dof), efc.con_chain1,
                            efc.con_chain2, 6, 6)
    tefc = tcg._efc(st, *a[3:])
    rng = np.random.default_rng(3)
    x = rng.normal(size=jm.nv).astype(np.float32)
    lj, cj = tefc.jx(torch.as_tensor(x)[None])
    lw, cw = efc_d.jx(jnp.asarray(x))
    tp.assert_close(lj[0], lw, 1e-5, 1e-6, "lim_jx")
    tp.assert_close(cj[0], cw, 1e-5, 1e-5, "con_jx")
    lf = rng.normal(size=efc.nlimit).astype(np.float32)
    cf = rng.normal(size=(efc.ncon, 4)).astype(np.float32)
    got = tefc.jt_f(torch.as_tensor(lf)[None], torch.as_tensor(cf)[None])
    tp.assert_close(got[0], efc_d.jt_f(jnp.asarray(lf), jnp.asarray(cf)),
                    1e-4, 1e-5, "jt_f")
    assert isinstance(tefc, tcon.EfcSystem)


def _contact_box():
    from vnl_tpu import mjcf, physics
    jm = mjcf.load_model(tp.CONTACT_BOX)
    d = jax.vmap(lambda _: physics.forward(jm, physics.make_data(jm)))(
        jnp.arange(1))
    efc, args = _batched(jm, d, 1)
    lim_dof = np.zeros(1, np.int32)         # the inert row the port adds
    args = list(map(tp.to_torch, args))
    args[5:8] = [torch.zeros(1, 1)] * 3
    st = tcg.CgStatics.make(jm.nv, lim_dof, efc.con_chain1, efc.con_chain2,
                            jm.opt.iterations, jm.opt.ls_iterations)
    return st, args


def _twin_system(twin):
    jm, _, efc, args, _, _ = twin
    return _statics(jm, efc, 6, 6), [tp.to_torch(a[:1]) for a in args]


@pytest.mark.parametrize("scene", ["twin", "contact_box"])
def test_limit_map_inverts_lim_dof(twin, scene):
    st, _ = _twin_system(twin) if scene == "twin" else _contact_box()
    inv = tcg.kernel_tables(st)["lim_of_dof"]
    assert inv.shape == (st.nv,)
    np.testing.assert_array_equal(inv[st.lim_dof], np.arange(st.nlimit))
    assert np.all(inv[np.setdiff1d(np.arange(st.nv), st.lim_dof)] == -1)
    with pytest.raises(ValueError):         # two rows on one dof
        tcg.kernel_tables(tcg.CgStatics.make(
            st.nv, np.array([0, 0], np.int32), st.chain1, st.chain2, 1, 1))


@pytest.mark.parametrize("scene", ["twin", "contact_box"])
def test_chain_tables_reproduce_chain_masks(twin, scene):
    """The per-side dof lists and per-dof side lists of kernel B rebuild
    chain2 / chain1 exactly, and J v and J^T f computed from them in numpy
    (as the kernel walks them) match the port's EfcSystem."""
    st, a = _twin_system(twin) if scene == "twin" else _contact_box()
    t = tcg.kernel_tables(st)
    nc, nv = st.ncon, st.nv
    sides = np.zeros((2 * nc, nv), np.float32)
    for sc in range(2 * nc):
        own = t["side_dof"][t["side_start"][sc]:t["side_start"][sc + 1]]
        assert np.all(np.diff(own) > 0)
        sides[sc, own] = 1
    np.testing.assert_array_equal(sides[:nc], st.chain2)
    np.testing.assert_array_equal(sides[nc:], st.chain1)
    back = np.zeros_like(sides)
    for d in range(nv):
        own = t["dof_side"][t["dof_start"][d]:t["dof_start"][d + 1]]
        assert len(set(own.tolist())) == len(own)
        back[own, d] = 1
    np.testing.assert_array_equal(back, sides)

    cdof, g36, lsign = (np.asarray(a[i][0], np.float64) for i in (3, 4, 5))
    mu = np.asarray(a[8][0], np.float64)
    g = g36.reshape(2, 3, 6, nc)                     # [sd, f, k, c]
    rng = np.random.default_rng(5)
    v = rng.normal(size=nv)
    side = np.stack([(cdof[o] * v[o, None]).sum(0) for o in (
        t["side_dof"][t["side_start"][sc]:t["side_start"][sc + 1]]
        for sc in range(2 * nc))])                   # (2 nc, 6)
    base = (np.einsum("fkc,ck->cf", g[0], side[:nc])
            - np.einsum("fkc,ck->cf", g[1], side[nc:]))
    rows = np.stack([base[:, 0] + mu[:, 0] * base[:, 1],
                     base[:, 0] - mu[:, 0] * base[:, 1],
                     base[:, 0] + mu[:, 1] * base[:, 2],
                     base[:, 0] - mu[:, 1] * base[:, 2]], -1)
    tefc = tcg._efc(st, *a[3:])
    lj, cj = tefc.jx(torch.as_tensor(v, dtype=torch.float32)[None])
    tp.assert_close(torch.as_tensor(lsign * v[st.lim_dof]), lj[0], 1e-5, 1e-6,
                    "lim_jx")
    tp.assert_close(torch.as_tensor(rows), cj[0], 1e-4, 1e-5, "con_jx")

    lf = rng.normal(size=st.nlimit)
    cf = rng.normal(size=(nc, 4))
    fv = np.stack([cf.sum(-1), mu[:, 0] * (cf[:, 0] - cf[:, 1]),
                   mu[:, 1] * (cf[:, 2] - cf[:, 3])], -1)        # (nc, 3)
    gf = np.concatenate([np.einsum("fkc,cf->ck", g[sd], fv)
                         for sd in (0, 1)])                      # (2 nc, 6)
    jtf = np.zeros(nv)
    for d in range(nv):
        u = np.zeros(6)
        for sc in t["dof_side"][t["dof_start"][d]:t["dof_start"][d + 1]]:
            u += gf[sc] if sc < nc else -gf[sc]
        jtf[d] = cdof[d] @ u
        if t["lim_of_dof"][d] >= 0:
            row = t["lim_of_dof"][d]
            jtf[d] += lsign[row] * lf[row]
    want = tefc.jt_f(torch.as_tensor(lf, dtype=torch.float32)[None],
                     torch.as_tensor(cf, dtype=torch.float32)[None])
    tp.assert_close(torch.as_tensor(jtf), want[0], 1e-4, 1e-5, "jt_f")


@pytest.mark.parametrize("case", ["plain", "float64", "far", "too_many",
                                  "not_finite"])
def test_check_cg_yardstick(twin, case):
    """kernel_bench.check_cg, the yardstick of kernel B on the card, fed on
    the CPU with stand-ins for the kernel's outputs: the plain float32
    result passes with no env off; the float64 result passes, and an env
    of it that is pushed past the float32 result still passes as one off
    env of a large batch; a result beyond the tolerance of both, more off
    envs than the share allowed, and a non-finite value are refused."""
    from vnl_tpu_torch import kernel_bench
    jm, _, efc, args, _, _ = twin
    st = _statics(jm, efc, 6, 6)
    args = [tp.to_torch(a) for a in args]
    plain = tcg.cg_plain(*args, statics=st)
    ref = tcg.cg_plain(*[a.double() for a in args], statics=st)
    if case == "plain":
        out = kernel_bench.check_cg(st, args, plain)
        assert out["off_envs"] == 0 and out["qacc"] == 0.0
    elif case == "float64":
        ker = [r.float() for r in ref]
        out = kernel_bench.check_cg(st, args, ker, max_off=0.25)
        assert out["off_envs"] <= 1 and out["unstable_envs"] == 0
        # env 0: on the far side of the float64 result, within the tolerance
        # of it and beyond the tolerance of the float32 one
        i = int(ref[0][0].abs().argmax())
        want, p = float(ref[0][0, i]), float(plain[0][0, i])
        step = 0.9e-3 * (1 + abs(want))
        ker[0][0, i] = want + (step if want >= p else -step)
        gap = abs(float(ker[0][0, i]) - p)
        out = kernel_bench.check_cg(st, args, ker, max_off=0.25)
        assert out["off_envs"] == int(gap > 1e-3 * (1 + abs(p)))
    elif case == "far":
        ker = [p.clone() for p in plain]
        ker[0][1, 3] += 0.01 * (1 + float(ker[0][1, 3].abs()))
        with pytest.raises(AssertionError, match="float64"):
            kernel_bench.check_cg(st, args, ker)
    elif case == "too_many":
        # one env of four leans on the float64 result: more than 0.5%
        ker = [p.clone() for p in plain]
        nudge = 1.05e-3 * (1 + plain[0][0].abs())
        ker[0][0] = plain[0][0] + nudge * torch.sign(ref[0][0].float()
                                                     - plain[0][0])
        far = ((ker[0][0].double() - ref[0][0]).abs()
               > 1e-3 * (1 + ref[0][0].abs())).any()
        with pytest.raises(AssertionError,
                           match="float64" if far else "at most 0"):
            kernel_bench.check_cg(st, args, ker)
    else:
        ker = [p.clone() for p in plain]
        ker[2][0, 0, 0] = float("nan")
        with pytest.raises(AssertionError, match="not finite"):
            kernel_bench.check_cg(st, args, ker)


@pytest.fixture(scope="module")
def humanoid_cg():
    """128 humanoid contact states at the CG solve's inputs (6 iterations,
    729 rows)."""
    from vnl_tpu_torch import kernel_bench
    from vnl_tpu_torch.envs.humanoid import load_humanoid_model
    m = load_humanoid_model(device="cpu")
    gen = torch.Generator().manual_seed(8)
    return kernel_bench.contact_states(m, 128, gen, press=0.3)[0]


@pytest.mark.parametrize("case", ["rerun", "scaled", "fewer_iterations"])
def test_check_cg_reruns_humanoid(humanoid_cg, case):
    """kernel_bench.check_cg_reruns on humanoid contact states, where no
    float32 evaluation meets check_cg's rule: the plain solve re-run with
    its inputs moved by one rounding (scaled by 1 + 2e-7 N(0, 1)) stands
    in for the kernel and passes, and so fails check_cg; qfrc_constraint
    1% off on every env, and a solve of 5 iterations instead of 6, are
    refused."""
    from vnl_tpu_torch import kernel_bench
    args, st = humanoid_cg
    if case == "rerun":
        g2 = torch.Generator().manual_seed(100)
        other = tcg.cg_plain(*[a * (1 + 2e-7 * torch.randn(
            a.shape, generator=g2)) for a in args], statics=st)
        out = kernel_bench.check_cg_reruns(st, args, other)
        assert 0 < out["far_envs"] <= out["budget_far"]
        with pytest.raises(AssertionError, match="float64"):
            kernel_bench.check_cg(st, args, other)
        return
    if case == "scaled":
        plain = tcg.cg_plain(*args, statics=st)
        bad = [plain[0], plain[1] * 1.01, plain[2]]
    else:
        bad = tcg.cg_plain(*args, statics=tcg.CgStatics.make(
            st.nv, st.lim_dof, st.chain1, st.chain2, 5, st.ls_iters))
    with pytest.raises(AssertionError, match="at most"):
        kernel_bench.check_cg_reruns(st, args, bad)


# ---- the per-body tables of kernel B's wide route (ops/cg.py body_tables) --

def _box_chain_system():
    from vnl_tpu_torch import compat, kernel_bench
    m = compat.model_from_numpy(compat.BOX_CHAIN_MODEL, device="cpu")
    (args, st), _ = kernel_bench.contact_states(
        m, 1, torch.Generator().manual_seed(0), press=0.0)
    return st, list(args)


def _system(scene, twin, humanoid_cg):
    if scene == "twin":
        return _twin_system(twin)
    if scene == "contact_box":
        return _contact_box()
    if scene == "box_chain":
        return _box_chain_system()
    args, st = humanoid_cg
    return st, [a[:1] for a in args]


def _walk(vals, dtype):
    """Sum of ``vals`` one after another in ``dtype`` (a thread's walk)."""
    acc = dtype(0)
    for v in vals:
        acc = dtype(acc + dtype(v))
    return acc


SCENES = ["twin", "contact_box", "box_chain", "humanoid"]


@pytest.mark.parametrize("scene", SCENES)
def test_body_tables_group_sides_by_chain(twin, humanoid_cg, scene):
    """Every group is one chain and holds exactly the sides of that chain;
    the chunks cut each group's ascending side list; each dof's chunks are
    those whose chain holds the dof; no more chunks than THREADS / 6 where
    chunks of one side would allow it."""
    st, _ = _system(scene, twin, humanoid_cg)
    t = tcg.kernel_tables(st)
    nc = st.ncon
    sides = np.concatenate([st.chain2, st.chain1]) != 0
    ngrp = len(t["grp_start"]) - 1
    chains = [t["grp_dof"][t["grp_start"][g]:t["grp_start"][g + 1]]
              for g in range(ngrp)]
    assert len({c.tobytes() for c in chains}) == ngrp
    for sc in range(2 * nc):
        g = t["grp_of_side"][sc]
        if not sides[sc].any():
            assert g == ngrp
        else:
            np.testing.assert_array_equal(chains[g], np.flatnonzero(sides[sc]))
    nchunk = len(t["chunk_start"]) - 1
    chunk_grp = []
    for ch in range(nchunk):
        own = t["chunk_side"][t["chunk_start"][ch]:t["chunk_start"][ch + 1]]
        assert 0 < len(own) <= t["chunk_len"] and np.all(np.diff(own) > 0)
        assert len(set(t["grp_of_side"][own].tolist())) == 1
        chunk_grp.append(t["grp_of_side"][own[0]])
    np.testing.assert_array_equal(
        np.sort(t["chunk_side"]), np.flatnonzero(sides.any(1)))
    if nchunk * 6 > tcg.THREADS:
        assert t["chunk_len"] == max(np.bincount(t["grp_of_side"])[:ngrp])
    for d in range(st.nv):
        own = t["dof_chunk"][t["dof_cstart"][d]:t["dof_cstart"][d + 1]]
        want = [ch for ch in range(nchunk) if d in chains[chunk_grp[ch]]]
        np.testing.assert_array_equal(own, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("scene", SCENES)
def test_body_tables_reproduce_jtf(twin, humanoid_cg, scene, dtype):
    """J^T f as kernel B's wide route adds it (per chunk and component the
    chunk's sides' G f, per dof the chunks below its body, times cdof,
    plus the limit row) against the port's J^T f over the chain masks, in
    float64 and float32."""
    st, a = _system(scene, twin, humanoid_cg)
    t = tcg.kernel_tables(st)
    nc, nv = st.ncon, st.nv
    cdof, g36, lsign, mu = (np.asarray(a[i][0], np.float64).astype(dtype)
                            for i in (3, 4, 5, 8))
    g = g36.reshape(2, 3, 6, nc)                     # [sd, f, k, c]
    rng = np.random.default_rng(11)
    lf = rng.normal(size=st.nlimit).astype(dtype)
    cf = rng.normal(size=(nc, 4)).astype(dtype)
    fv = np.stack([((cf[:, 0] + cf[:, 1]) + cf[:, 2]) + cf[:, 3],
                   mu[:, 0] * (cf[:, 0] - cf[:, 1]),
                   mu[:, 1] * (cf[:, 2] - cf[:, 3])], -1)
    nchunk = len(t["chunk_start"]) - 1
    part = np.zeros((nchunk, 6), dtype)
    for ch in range(nchunk):
        for k in range(6):
            terms = []
            for sc in t["chunk_side"][t["chunk_start"][ch]:
                                      t["chunk_start"][ch + 1]]:
                sd, c = divmod(int(sc), nc)
                gf = _walk(g[sd, :, k, c] * fv[c], dtype)
                terms.append(-gf if sd else gf)
            part[ch, k] = _walk(terms, dtype)
    jtf = np.zeros(nv, dtype)
    for d in range(nv):
        own = t["dof_chunk"][t["dof_cstart"][d]:t["dof_cstart"][d + 1]]
        u = np.array([_walk(part[own, k], dtype) for k in range(6)])
        jtf[d] = _walk(cdof[d] * u, dtype)
        if t["lim_of_dof"][d] >= 0:
            row = t["lim_of_dof"][d]
            jtf[d] = dtype(jtf[d] + lsign[row] * lf[row])
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tefc = tcg._efc(st, *[x.to(tdt) for x in a[3:]])
    want = tefc.jt_f(torch.as_tensor(lf)[None], torch.as_tensor(cf)[None])[0]
    scale = float(want.abs().max()) + 1.0
    tol = 1e-11 if dtype == np.float64 else 2e-6
    tp.assert_close(torch.as_tensor(jtf), want, tol, tol * scale, "jt_f")


@pytest.mark.parametrize("scene", SCENES)
def test_body_path_sums_keep_jv_bits(twin, humanoid_cg, scene):
    """J v's first half once a body (one walk a group and component, read
    by every side of the group) equals the per-side walks bit for bit in
    float32: a group's dofs are its sides' dofs in the same order."""
    st, a = _system(scene, twin, humanoid_cg)
    t = tcg.kernel_tables(st)
    nc = st.ncon
    cdof = np.asarray(a[3][0], np.float32)
    v = np.random.default_rng(12).normal(size=st.nv).astype(np.float32)
    ngrp = len(t["grp_start"]) - 1
    grp = np.zeros((ngrp + 1, 6), np.float32)
    for gi in range(ngrp):
        dofs = t["grp_dof"][t["grp_start"][gi]:t["grp_start"][gi + 1]]
        grp[gi] = [_walk(cdof[dofs, k] * v[dofs], np.float32)
                   for k in range(6)]
    for sc in range(2 * nc):
        dofs = t["side_dof"][t["side_start"][sc]:t["side_start"][sc + 1]]
        side = np.array([_walk(cdof[dofs, k] * v[dofs], np.float32)
                         for k in range(6)], np.float32)
        np.testing.assert_array_equal(grp[t["grp_of_side"][sc]], side)


def test_kernel_name_routes(twin, humanoid_cg):
    """The route of each system: the twin's 159 rows on one warp, the
    humanoid's 729 on the wide route with 3 contact rows a thread, and
    beyond 1,024 contact rows or 256 limit rows the shared-memory line
    search; the source instantiates the wide route's slot counts."""
    import os
    import re
    st_twin, _ = _twin_system(twin)
    assert tcg.kernel_name(st_twin) == "cg_kernel<5>"
    st_h = humanoid_cg[1]
    assert tcg.kernel_name(st_h) == "cg_wide_kernel<3,1>"

    def made(ncon, nlimit):
        chain = np.zeros((ncon, 4), np.float32)
        chain[:, 0] = 1
        return tcg.CgStatics.make(4, np.arange(nlimit) % 4 if nlimit <= 4
                                  else np.arange(nlimit), chain, chain, 1, 1)

    assert tcg.kernel_name(made(39, 4)) == "cg_kernel<5>"         # 160 rows
    assert tcg.kernel_name(made(40, 4)) == "cg_wide_kernel<1,1>"
    assert tcg.kernel_name(made(256, 1)) == "cg_wide_kernel<4,1>"
    assert tcg.kernel_name(made(257, 1)) == "cg_kernel<0>"
    st = tcg.CgStatics.make(300, np.arange(257), np.zeros((40, 300)),
                            np.zeros((40, 300)), 1, 1)
    assert tcg.kernel_name(st) == "cg_kernel<0>"
    src = open(os.path.join(os.path.dirname(tcg.__file__), os.pardir,
                            "csrc", "cg.cu")).read()
    made_slots = sorted(int(n) for n in
                        re.findall(r"cg_wide_kernel<(\d+), 1>;", src))
    assert tuple(made_slots) == tcg.WIDE_SLOTS


def test_structs_mirror_the_source():
    """The ctypes structs of ops/cg.py list the fields of CgModel and
    CgWide in cg.cu, in order, with their C types."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tcg.__file__), os.pardir,
                            "csrc", "cg.cu")).read()
    for struct in (tcg.CgModel, tcg.CgWide):
        body = re.search(r"struct %s \{(.*?)\};" % struct.__name__, src,
                         re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        fields = []
        for decl in body.split(";"):
            m = re.match(r"\s*(int|const int\*)\s+(.*)", decl.strip())
            if m:
                ctype = ctypes.c_int if m.group(1) == "int" else \
                    ctypes.c_void_p
                fields += [(n.strip().lstrip("*"), ctype)
                           for n in m.group(2).split(",")]
        assert fields == list(struct._fields_), struct.__name__
