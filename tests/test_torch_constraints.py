"""Kernel D's tables, its plain route and the constraint stage's routing on
the CPU (ops/constraints.py).  The kernel itself runs only on the card
(tests/test_torch_cuda.py); here its arithmetic is followed step by step
in PyTorch from its tables and held against make_constraints, which
checks every static quantity the tables carry."""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from vnl_tpu_torch import compat, kernel_bench, mjcf
from vnl_tpu_torch import math as vmath
from vnl_tpu_torch.envs.humanoid import load_humanoid_model
from vnl_tpu_torch.ops import cg as cg_ops
from vnl_tpu_torch.ops import constraints as con_ops
from vnl_tpu_torch.physics import collision, constraint, forward
from vnl_tpu_torch.physics.model import ConeType, DisableBit, SolverType

B = 4


def _scene(name):
    if name == "twin":
        return compat.model_from_numpy(compat.TWIN_MODEL, device="cpu"), 0.005
    if name == "humanoid":
        return load_humanoid_model(device="cpu"), 0.3
    if name == "ant":           # Newton; margin 0.01
        return mjcf.load_model(compat.GYM_ANT_XML, device="cpu"), 0.3
    # box_chain on the CG solver: contacts between moving bodies, no limit
    m = compat.model_from_numpy(compat.BOX_CHAIN_MODEL, device="cpu")
    return dataclasses.replace(m, cache={}, opt=dataclasses.replace(
        m.opt, solver=int(SolverType.CG))), 0.0


@functools.lru_cache(maxsize=None)
def _states(name):
    """(name, model, data, con_dist, con_pos, con_frame, con_pair) at
    states whose contacts and limit rows sit near, at and past where they
    act."""
    m, press = _scene(name)
    gen = torch.Generator().manual_seed(11)
    return (name, m) + kernel_bench.constraint_states(m, B, gen, press,
                                                      edges=True)


ALL = ["twin", "humanoid", "ant", "box_chain"]
KERNEL_D = ["twin", "humanoid", "box_chain"]    # CG, pyramidal, contacts


def _impedance(p, r):
    """constraint._impedance with the tables' pre-clamped parameters."""
    x = torch.clamp(torch.abs(r) / p["width"], 0.0, 1.0)
    y_lo = (x / p["mid"]) ** p["power"] * p["mid"]
    y_hi = 1.0 - ((1.0 - x) / (1.0 - p["mid"])) ** p["power"] * (
        1.0 - p["mid"])
    y = torch.where(x < p["mid"], y_lo, y_hi)
    return torch.clamp(p["d0"] + y * (p["dmax"] - p["d0"]), 1e-5, 1.0 - 1e-5)


def _kernel_d(t, d, dist, cpos, frame):
    """Kernel D's outputs worked out as its source does, from its tables."""
    Bn, nc = dist.shape
    lim = dict(zip(con_ops.LIMIT_FIELDS, torch.as_tensor(t["lim_flt"])))
    con = dict(zip(con_ops.CONTACT_FIELDS, torch.as_tensor(t["con_flt"])))
    if len(t["lim_dof"]):
        qadr, dof = (torch.as_tensor(a, dtype=torch.long)
                     for a in t["lim_int"])
        q = d.qpos[:, qadr]
        dlo, dhi = q - lim["lo"], lim["hi"] - q
        sign = torch.where(dlo < dhi, 1.0, -1.0)
        pos = torch.minimum(dlo, dhi) - lim["margin"]
        imp = torch.where(pos < 0, _impedance(lim, pos),
                          torch.full_like(pos, 1e-7))
        R = torch.clamp((1.0 - imp) / imp * lim["invweight"], min=1e-10)
        rows = (sign, -lim["b"] * (sign * d.qvel[:, dof])
                - lim["k"] * imp * pos, 1.0 / R, pos)
    else:
        rows = (torch.zeros(Bn, 1),) * 4
    cx = d.cdof * d.qvel[..., None]
    start = t["grp_start"]
    s = torch.stack([cx[:, t["grp_dof"][a:b]].sum(1)
                     for a, b in zip(start[:-1], start[1:])]
                    + [torch.zeros(Bn, 6)], 1)
    root1, root2, grp1, grp2 = (torch.as_tensor(a, dtype=torch.long)
                                for a in t["con_int"])

    def side(root, grp):
        r = cpos - d.subtree_com[:, root]
        G = torch.cat([vmath.cross(r[:, :, None, :], frame), frame], -1)
        return G, (G * s[:, grp, None, :]).sum(-1)

    (G2, v2), (G1, v1) = side(root2, grp2), side(root1, grp1)
    n, t1, t2 = (v2 - v1).unbind(-1)
    mu1, mu2 = con["mu1"], con["mu2"]
    fvel = torch.stack([n + mu1 * t1, n - mu1 * t1, n + mu2 * t2,
                        n - mu2 * t2], -1)
    pos = dist - con["margin"]
    imp = torch.where(dist < con["thresh"], _impedance(con, pos),
                      torch.full_like(pos, 1e-7))
    diag = torch.stack([con[f"diag{f}"] for f in range(4)], -1)
    on = torch.stack([con[f"on{f}"] for f in range(4)], -1)
    R = torch.clamp(((1.0 - imp) / imp)[..., None] * diag, min=1e-10)
    aref = (-con["b"][:, None] * fvel - (con["k"] * imp * pos)[..., None]) \
        * on
    g36 = torch.cat([G.permute(0, 2, 3, 1).reshape(Bn, 18, nc)
                     for G in (G2, G1)], 1)
    return (g36,) + rows + (aref, on / R, pos)


def _plain(m, d, dist, cpos, frame, pair):
    efc = constraint.make_constraints(m, d, dist, cpos, frame, pair,
                                      materialize_jc=False)
    return efc, cg_ops.kernel_b_system(m, efc)


@pytest.mark.parametrize("name", ALL)
def test_tables_reproduce_make_constraints(name):
    """The kernel's arithmetic on its tables gives make_constraints' system
    to within float32 rounding (rtol 1e-5, atol 1e-5 of each output's
    largest entry): ranges, margins, solimp, (k, b), the invweights, mu,
    the facets' diagonal and which act, roots and chains.  Contacts and
    limit rows sit near, at and past where they act."""
    name, m, d, dist, cpos, frame, pair = _states(name)
    t = con_ops.kernel_tables(m, pair)
    efc, packed = _plain(m, d, dist, cpos, frame, pair)
    want = (cg_ops.g36(packed), packed.lim_sign, packed.lim_aref,
            packed.lim_D, packed.lim_pos, efc.con_aref, efc.con_D,
            efc.con_pos)
    active = efc.con_pos < 0
    assert bool(active.any()) and not bool(active.all()), name
    if efc.nlimit:
        assert bool((efc.lim_pos < 0).any()), name
    for out, g, w in zip(con_ops.OUTPUT_NAMES, _kernel_d(t, d, dist, cpos,
                                                         frame), want):
        assert g.shape == w.shape, out
        scale = float(w.abs().max())
        err = (g - w).abs()
        assert bool((err <= 1e-5 * scale + 1e-5 * w.abs()).all()), (
            name, out, float(err.max()))
    np.testing.assert_array_equal(t["lim_dof"], efc.lim_dof)
    np.testing.assert_array_equal(t["chain1"], efc.con_chain1)
    np.testing.assert_array_equal(t["chain2"], efc.con_chain2)
    assert torch.equal(torch.as_tensor(t["mu"]), efc.con_mu[0])
    sides = np.concatenate([t["chain2"], t["chain1"]]) != 0
    ngrp = len(t["grp_start"]) - 1
    for sd, grp in ((0, t["con_int"][3]), (1, t["con_int"][2])):
        for c, g in enumerate(grp):
            want_dofs = np.flatnonzero(sides[sd * len(pair) + c])
            got_dofs = (t["grp_dof"][t["grp_start"][g]:t["grp_start"][g + 1]]
                        if g < ngrp else np.zeros(0))
            np.testing.assert_array_equal(got_dofs, want_dofs)
    body = np.asarray(m.geom_bodyid)
    for row, geoms in ((0, m.pair_geom1), (1, m.pair_geom2)):
        np.testing.assert_array_equal(
            t["con_int"][row],
            np.asarray(m.body_rootid)[body[np.asarray(geoms)[pair]]])
    on = t["con_flt"][con_ops.CONTACT_FIELDS.index("on1")]
    np.testing.assert_array_equal(on, np.asarray(m.pair_dim)[pair] >= 3)


@pytest.mark.parametrize("direct", ["pairs", "joints"])
def test_tables_take_the_direct_solref(direct):
    """(k, b) of a negative solref is (-solref): the direct format of _kb,
    on half the contacts or half the limit rows."""
    m, _ = _scene("twin")
    name = "pair_solref" if direct == "pairs" else "jnt_solref"
    ref = getattr(m, name).clone()
    ref[::2] = torch.tensor([-5000.0, -30.0])
    m = dataclasses.replace(m, cache={}, **{name: ref})
    gen = torch.Generator().manual_seed(12)
    d, dist, cpos, frame, pair = kernel_bench.constraint_states(
        m, B, gen, edges=True)
    t = con_ops.kernel_tables(m, pair)
    key, fields = (("con_flt", con_ops.CONTACT_FIELDS) if direct == "pairs"
                   else ("lim_flt", con_ops.LIMIT_FIELDS))
    k = t[key][fields.index("k")]
    b = t[key][fields.index("b")]
    rows = (np.asarray(pair) if direct == "pairs"
            else constraint.limit_ids(m))
    is_direct = ref[rows, 0].numpy() <= 0
    assert is_direct.any() and not is_direct.all()
    assert np.all(k[is_direct] == 5000.0) and np.all(b[is_direct] == 30.0)
    efc, packed = _plain(m, d, dist, cpos, frame, pair)
    for out, g, w in zip(con_ops.OUTPUT_NAMES,
                         _kernel_d(t, d, dist, cpos, frame),
                         (cg_ops.g36(packed), packed.lim_sign,
                          packed.lim_aref, packed.lim_D, packed.lim_pos,
                          efc.con_aref, efc.con_D, efc.con_pos)):
        scale = float(w.abs().max())
        assert bool(((g - w).abs() <= 1e-5 * scale + 1e-5 * w.abs()).all()
                    ), out


@pytest.mark.parametrize("name", KERNEL_D)
def test_cpu_route_is_make_constraints_then_cg_inputs(name):
    """On CPU tensors the plain route returns make_constraints ->
    cg_inputs' arrays bit for bit (a contact-only model's inert limit row
    included)."""
    name, m, d, dist, cpos, frame, pair = _states(name)
    got = con_ops.constraints_plain(m, d, dist, cpos, frame, pair)
    efc, packed = _plain(m, d, dist, cpos, frame, pair)
    args, _ = cg_ops.cg_inputs(m, d, efc, torch.zeros(B, m.nv),
                               max(m.opt.iterations, 1))
    want = (args[4], args[5], args[6], args[7], packed.lim_pos, args[9],
            args[10], efc.con_pos)
    for out, g, w in zip(con_ops.OUTPUT_NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, out
        assert g.numpy().tobytes() == w.numpy().tobytes(), out
    assert got[1].shape[1] == max(efc.nlimit, 1)


@pytest.mark.parametrize("name", KERNEL_D)
def test_kernel_system_steps_as_the_plain_system(name, monkeypatch):
    """The system that ``system`` builds from kernel D's outputs (G1 and
    G2 as views of g36, the cached con_mu, the inert row) steps the
    physics as make_constraints' does, bit for bit: here with the plain
    route standing in for the launch."""
    name, m, d, *_ = _states(name)
    m = dataclasses.replace(m, cache={})
    plain = forward.step(m, d)

    def launch(m, qpos, qvel, subtree_com, cdof, *contacts):
        dd = forward.make_data(m, qpos.shape[0], qpos=qpos, qvel=qvel)
        return con_ops.constraints_plain(
            m, dd.replace(subtree_com=subtree_com, cdof=cdof), *contacts)

    monkeypatch.setattr(con_ops, "takes_kernel", lambda m, qpos: True)
    monkeypatch.setattr(con_ops, "_launch", launch)
    con_dist, con_pos, con_frame, con_pair = collision.collide(m, d)
    efc = con_ops.system(m, d, con_dist, con_pos, con_frame, con_pair)
    assert efc.g36 is not None and efc.nlimit >= 1
    assert efc.con_G2.data_ptr() == efc.g36.data_ptr()
    assert efc.con_mu.is_contiguous() and efc.con_mu.shape == (B, efc.ncon,
                                                               2)
    assert con_ops.system(m, d, con_dist, con_pos, con_frame,
                          con_pair).con_mu is efc.con_mu
    fused = forward.step(m, d)
    for f in ("qpos", "qvel", "qacc", "qfrc_constraint", "contact_force"):
        a, b = getattr(plain, f), getattr(fused, f)
        assert a.numpy().tobytes() == b.numpy().tobytes(), (name, f)


def test_system_routes_by_what_it_sees():
    """Kernel D where kernel B solves: a CUDA tensor, CG, the pyramidal
    cone and contacts; make_constraints' on the CPU, for Newton, the
    elliptic cone and contacts or constraints disabled."""
    card = types.SimpleNamespace(is_cuda=True)
    twin, _ = _scene("twin")
    humanoid, _ = _scene("humanoid")
    ant, _ = _scene("ant")
    assert con_ops.takes_kernel(twin, card)
    assert con_ops.takes_kernel(humanoid, card)
    assert not con_ops.takes_kernel(twin, torch.zeros(1))
    assert not con_ops.takes_kernel(ant, card)

    def opt(**kw):
        return dataclasses.replace(twin, cache={}, opt=dataclasses.replace(
            twin.opt, **kw))

    assert not con_ops.takes_kernel(opt(cone=int(ConeType.ELLIPTIC)), card)
    assert not con_ops.takes_kernel(opt(disableflags=int(
        DisableBit.CONTACT)), card)
    assert not con_ops.takes_kernel(opt(disableflags=int(
        DisableBit.CONSTRAINT)), card)
    # limits off, contacts on: the kernel, with the inert row
    no_limits = opt(disableflags=int(DisableBit.LIMIT))
    assert con_ops.takes_kernel(no_limits, card)
    from vnl_tpu_torch.physics import collision
    t = con_ops.kernel_tables(no_limits, collision.pair_expansion(twin))
    assert len(t["lim_dof"]) == 0 and t["lim_flt"].shape == (
        len(con_ops.LIMIT_FIELDS), 0)


@pytest.mark.parametrize("name", KERNEL_D)
def test_wrapper_rejects_bad_inputs(name):
    """Wrong dtypes, shapes, layouts, devices and models are refused with
    a ValueError before anything is built or launched."""
    name, m, d, dist, cpos, frame, pair = _states(name)
    ok = dict(con_dist=dist, con_pos=cpos, con_frame=frame)

    def launch(dd=d, **kw):
        a = dict(ok, **kw)
        return con_ops._launch(m, dd.qpos, dd.qvel, dd.subtree_com.contiguous(),
                               dd.cdof, a["con_dist"], a["con_pos"],
                               a["con_frame"], pair)

    with pytest.raises(ValueError, match="qpos must be contiguous float32"):
        launch(d.replace(qpos=d.qpos.double()))
    with pytest.raises(ValueError, match="con_frame"):
        launch(con_frame=frame[:, :, :2])
    with pytest.raises(ValueError, match="cdof"):
        launch(d.replace(cdof=d.cdof.transpose(1, 2).contiguous()
                         .transpose(1, 2)))
    with pytest.raises(ValueError, match="con_dist"):
        launch(con_dist=dist[:1])
    meta = d.replace(**{f.name: getattr(d, f.name).to("meta")
                        for f in dataclasses.fields(d)})
    with pytest.raises(ValueError, match="on cpu, got"):
        launch(meta, con_dist=dist.to("meta"), con_pos=cpos.to("meta"),
               con_frame=frame.to("meta"))
    with pytest.raises(ValueError, match="on cpu, got"):
        con_ops.constraints(m, meta, dist.to("meta"), cpos.to("meta"),
                            frame.to("meta"), pair)
    _, ant, ad, *contacts = _states("ant")      # Newton: no kernel D
    with pytest.raises(ValueError, match="CG solver"):
        con_ops.constraints(ant, ad, *contacts)
    elliptic = dataclasses.replace(m, cache={}, opt=dataclasses.replace(
        m.opt, cone=int(ConeType.ELLIPTIC)))
    with pytest.raises(ValueError, match="pyramidal"):
        con_ops._launch(elliptic, d.qpos, d.qvel, d.subtree_com, d.cdof,
                        dist, cpos, frame, pair)
