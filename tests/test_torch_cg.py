"""Kernel B's plain version (vnl_tpu_torch.ops.cg.cg_plain) against
vnl_tpu/physics/solver.py:215 _make_cg_reference, on rodent-twin states
pressed into the floor (setup of tests/test_pallas_cg.py:31-45) and on the
contact-only box with nlimit == 0 (:127-162); plus the port's collision and
constraint assembly against the JAX package's flat solver inputs.
Tolerance 1e-3 (tests/test_pallas_cg.py:120-124)."""

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
from vnl_tpu_torch.physics import solver as tsol

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
    got = tcg.cg(*map(tp.to_torch, args),
                 statics=_statics(jm, efc, 6, 6))      # CPU -> plain
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
    got, st = tsol.cg_inputs(tm, td, tefc, qacc_smooth, 6)
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
