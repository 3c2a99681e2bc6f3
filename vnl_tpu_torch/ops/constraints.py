"""Kernel D: the constraint system of a substep, joint limits and pyramidal
contacts, as kernel B takes it.

``constraints(m, d, con_dist, con_pos, con_frame, con_pair)`` launches
csrc/constraints.cu on the state (qpos, qvel, subtree_com and cdof of
``d``) and the contacts of ``collision.collide``, which it maps to kernel
B's constraint inputs
  g36 (B, 36, ncon) [G2 | G1 rows, f-major],
  lim_sign, lim_aref, lim_D, lim_pos (B, nlimit; a model without limits
    gets kernel B's inert row, sign 0 and D 0),
  con_aref, con_D (B, ncon, 4), con_pos (B, ncon).
``constraints_plain`` is the same in plain PyTorch: physics/constraint.py
make_constraints and the packing of ops/cg.py cg_inputs.

``system(...)`` is the constraint stage of forward's path: kernel D's
system where kernel B solves (a CUDA device, the CG solver, the pyramidal
cone, contacts), make_constraints' everywhere else (the CPU, Newton, the
elliptic cone, constraints or contacts disabled).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vnl_tpu_torch.ops import build
from vnl_tpu_torch.ops import cg as cg_ops
from vnl_tpu_torch.physics import constraint
from vnl_tpu_torch.physics.model import (ConeType, Data, DisableBit, Model,
                                         SolverType)

THREADS = 128       # kThreads of the source: one block per env
# the fields of the float tables, in the order of the source's LimF / ConF
LIMIT_FIELDS = ("lo", "hi", "margin", "d0", "dmax", "width", "mid", "power",
                "k", "b", "invweight")
CONTACT_FIELDS = ("margin", "thresh", "d0", "dmax", "width", "mid", "power",
                  "k", "b", "mu1", "mu2", "diag0", "diag1", "diag2", "diag3",
                  "on0", "on1", "on2", "on3")
OUTPUT_NAMES = ("g36", "lim_sign", "lim_aref", "lim_D", "lim_pos",
                "con_aref", "con_D", "con_pos")


def _refusal(m: Model) -> str:
    """Why kernel D cannot build this model's system; "" where it can."""
    if m.opt.solver != int(SolverType.CG) or \
            m.opt.cone != int(ConeType.PYRAMIDAL):
        return "kernel D builds the system of the CG solver with pyramidal "\
            "contacts"
    if m.ncon_max == 0 or \
            m.opt.disableflags & (DisableBit.CONSTRAINT | DisableBit.CONTACT):
        return "kernel D needs at least one contact"
    return ""


def takes_kernel(m: Model, qpos: torch.Tensor) -> bool:
    """Whether kernel D builds the system: where kernel B solves it."""
    return qpos.is_cuda and not _refusal(m)


def _solimp(solimp: torch.Tensor) -> dict:
    """_impedance's parameters with its static clamps applied."""
    d0, dmax, width, mid, power = solimp.unbind(-1)
    return dict(d0=d0, dmax=dmax, width=torch.clamp(width, min=1e-12),
                mid=torch.clamp(mid, 1e-4, 1.0 - 1e-4),
                power=torch.clamp(power, min=1.0))


def kernel_tables(m: Model, con_pair: np.ndarray) -> dict:
    """Static tables of kernel D for one model, float32 values worked out
    on the CPU by make_constraints' own expressions:
      lim_int (2, nlimit): qpos and dof address of each limit row;
      lim_flt (len(LIMIT_FIELDS), nlimit): range, margin, solimp (clamped),
        (k, b) and the clamped dof_invweight0;
      con_int (4, ncon): root body of side 1 and of side 2, chain group of
        side 1 and of side 2 (ngrp for the world's empty chain);
      con_flt (len(CONTACT_FIELDS), ncon): margin, margin - gap, solimp
        (clamped), (k, b), mu1, mu2, the four facets' clamped diagonal and
        which facets act (a frictionless contact through facet 0 only);
      grp_start, grp_dof: each group's chain (ops/cg.py body_tables);
      chain1, chain2 (ncon, nv): the chain masks of make_constraints;
      mu (ncon, 2), lim_dof (nlimit,)."""
    cpu = {n: getattr(m, n).detach().cpu() for n in (
        "jnt_range", "jnt_margin", "jnt_solimp", "jnt_solref",
        "dof_invweight0", "body_invweight0", "pair_margin", "pair_gap",
        "pair_solimp", "pair_solref", "pair_friction")}
    lim_ids = constraint.limit_ids(m)
    lim_dof = np.asarray(m.jnt_dofadr)[lim_ids].astype(np.int32)
    lid = torch.as_tensor(lim_ids, dtype=torch.long)
    k, b = constraint._kb(cpu["jnt_solref"][lid], cpu["jnt_solimp"][lid])
    lim = dict(lo=cpu["jnt_range"][lid, 0], hi=cpu["jnt_range"][lid, 1],
               margin=cpu["jnt_margin"][lid],
               **_solimp(cpu["jnt_solimp"][lid]), k=k, b=b,
               invweight=torch.clamp(cpu["dof_invweight0"][
                   torch.as_tensor(lim_dof, dtype=torch.long)], min=1e-12))

    con_pair = np.asarray(con_pair)
    ncon = len(con_pair)
    b1 = np.asarray(m.geom_bodyid)[np.asarray(m.pair_geom1)[con_pair]]
    b2 = np.asarray(m.geom_bodyid)[np.asarray(m.pair_geom2)[con_pair]]
    root = np.asarray(m.body_rootid)
    chain1 = np.asarray(m.body_chain_dof_mask)[b1].astype(np.float32)
    chain2 = np.asarray(m.body_chain_dof_mask)[b2].astype(np.float32)
    body = cg_ops.body_tables(np.concatenate([chain2, chain1]) != 0)
    pair = torch.as_tensor(con_pair, dtype=torch.long)
    margin, gap = cpu["pair_margin"][pair], cpu["pair_gap"][pair]
    solimp = cpu["pair_solimp"][pair]
    k, b = constraint._kb(cpu["pair_solref"][pair], solimp)
    mu1, mu2 = cpu["pair_friction"][pair, 0], cpu["pair_friction"][pair, 1]
    pyramid = torch.as_tensor(np.asarray(m.pair_dim)[con_pair] >= 3)
    iw_sum = (cpu["body_invweight0"][torch.as_tensor(b1, dtype=torch.long)]
              + cpu["body_invweight0"][torch.as_tensor(b2,
                                                       dtype=torch.long)])
    mu_f = torch.stack([mu1, mu1, mu2, mu2], -1)
    diag = torch.where(pyramid[:, None],
                       iw_sum[:, None] * 2.0 * (1.0 + mu_f * mu_f),
                       iw_sum[:, None].expand(-1, 4))
    facet_on = torch.cat([torch.ones(ncon, 1),
                          pyramid[:, None].float().expand(-1, 3)], -1)
    con = dict(margin=margin, thresh=margin - gap, **_solimp(solimp), k=k,
               b=b, mu1=mu1, mu2=mu2,
               **{f"diag{f}": torch.clamp(diag[:, f], min=1e-12)
                  for f in range(4)},
               **{f"on{f}": facet_on[:, f] for f in range(4)})
    grp = body["grp_of_side"]
    return dict(
        lim_dof=lim_dof,
        lim_int=np.stack([np.asarray(m.jnt_qposadr)[lim_ids],
                          lim_dof]).astype(np.int32).reshape(2, -1),
        lim_flt=torch.stack([lim[n] for n in LIMIT_FIELDS]).reshape(
            len(LIMIT_FIELDS), -1).numpy(),
        con_int=np.stack([root[b1], root[b2], grp[ncon:],
                          grp[:ncon]]).astype(np.int32),
        con_flt=torch.stack([con[n] for n in CONTACT_FIELDS]).numpy(),
        grp_start=body["grp_start"].astype(np.int32),
        grp_dof=body["grp_dof"].astype(np.int32),
        chain1=chain1, chain2=chain2,
        mu=torch.stack([mu1, mu2], -1).numpy())


_TABLES = ("lim_int", "lim_flt", "con_int", "con_flt", "grp_start",
           "grp_dof")


class ConModel(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("nq", "nv", "nbody", "ncon",
                                             "nlimit", "ngrp", "ngdof")]
                + [(n, ctypes.c_void_p) for n in _TABLES])


class ConIn(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "qpos", "qvel", "subtree_com", "cdof", "con_dist", "con_pos",
        "con_frame")]


class ConOut(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in OUTPUT_NAMES]


def _device_model(m: Model, con_pair: np.ndarray, device: torch.device):
    """(ConModel struct, tables) with the tables on ``device``, made once
    per model."""
    def make(device):
        t = kernel_tables(m, con_pair)
        held = build.on_device({n: t[n] for n in _TABLES}, device)
        return (ConModel(nq=m.nq, nv=m.nv, nbody=m.nbody, ncon=len(con_pair),
                         nlimit=len(t["lim_dof"]),
                         ngrp=len(t["grp_start"]) - 1,
                         ngdof=len(t["grp_dof"]),
                         **{n: held[n].data_ptr() for n in _TABLES}), t), held
    return build.tables(m, "constraints", device, make,
                         np.asarray(con_pair).tobytes())


def con_mu(m: Model, con_pair: np.ndarray, batch: int,
           device: torch.device) -> torch.Tensor:
    """The contacts' (mu1, mu2) as kernel B reads them, (batch, ncon, 2)
    contiguous, made once per model and batch."""
    def make(device):
        mu = torch.as_tensor(_device_model(m, con_pair, device)[1]["mu"],
                             device=device)
        return mu.expand(batch, -1, -1).contiguous(), None
    return build.tables(m, "constraints_mu", device, make, batch,
                         np.asarray(con_pair).tobytes())


def resources(m: Model, con_pair: np.ndarray) -> dict:
    """Registers per thread, local (spill) bytes, shared memory per block
    and resident blocks per SM of kernel D for this model."""
    return dict(build.resources("constraints",
                                _device_model(m, con_pair, m.device)[0]),
                threads=THREADS)


def constraints_plain(m: Model, d: Data, con_dist, con_pos, con_frame,
                      con_pair):
    """make_constraints, then cg_inputs' packing: kernel B's constraint
    inputs in plain PyTorch."""
    if why := _refusal(m):
        raise ValueError(why)
    efc = cg_ops.kernel_b_system(m, constraint.make_constraints(
        m, d, con_dist, con_pos, con_frame, con_pair, materialize_jc=False))
    return (cg_ops.g36(efc), efc.lim_sign, efc.lim_aref, efc.lim_D,
            efc.lim_pos, efc.con_aref, efc.con_D, efc.con_pos)


_ARGTYPES = (ConModel, ConIn, ConOut, ctypes.c_int)


def _launch(m: Model, qpos, qvel, subtree_com, cdof, con_dist, con_pos,
            con_frame, con_pair):
    """Launches kernel D."""
    if why := _refusal(m):
        raise ValueError(why)
    B, nc, nv = qpos.shape[0], len(con_pair), m.nv
    ins = (("qpos", qpos, (m.nq,)), ("qvel", qvel, (nv,)),
           ("subtree_com", subtree_com, (m.nbody, 3)),
           ("cdof", cdof, (nv, 6)), ("con_dist", con_dist, (nc,)),
           ("con_pos", con_pos, (nc, 3)), ("con_frame", con_frame, (nc, 3, 3)))
    build.check_inputs("constraints", m.device, (B,), *ins)
    dev = qpos.device
    st, t = _device_model(m, con_pair, dev)
    nl = max(len(t["lim_dof"]), 1)
    outs = [torch.empty((B,) + s, device=dev) for s in (
        (36, nc), (nl,), (nl,), (nl,), (nl,), (nc, 4), (nc, 4), (nc,))]
    build.launch("constraints", _ARGTYPES, dev, st,
                  ConIn(*[a.data_ptr() for _, a, _ in ins]),
                  ConOut(*[o.data_ptr() for o in outs]), B)
    return tuple(outs)


def constraints(m: Model, d: Data, con_dist, con_pos, con_frame, con_pair):
    """Kernel D on a batch: kernel B's constraint inputs, as
    ``constraints_plain`` gives them."""
    return _launch(m, *(x.contiguous() for x in (
        d.qpos, d.qvel, d.subtree_com, d.cdof, con_dist, con_pos,
        con_frame)), con_pair)


def system(m: Model, d: Data, con_dist, con_pos, con_frame,
           con_pair) -> constraint.EfcSystem:
    """The constraint system of forward's path: kernel D's where kernel B
    solves it (``takes_kernel``), else make_constraints'.  Kernel D's
    carries g36, with G1 and G2 as views of it, and a model without limits
    has kernel B's inert row in it."""
    if not takes_kernel(m, d.qpos):
        return constraint.make_constraints(m, d, con_dist, con_pos,
                                           con_frame, con_pair)
    dev = d.qpos.device
    g36, lim_sign, lim_aref, lim_D, lim_pos, con_aref, con_D, pos = \
        constraints(m, d, con_dist, con_pos, con_frame, con_pair)
    t = _device_model(m, con_pair, dev)[1]
    B, nc = g36.shape[0], g36.shape[2]
    if len(t["lim_dof"]):
        lim_dof = t["lim_dof"]
        onehot = constraint.limit_onehot(lim_dof, m.nv)
    else:       # kernel B's inert row, as cg.kernel_b_system adds it
        lim_dof = np.zeros(1, np.int32)
        onehot = np.zeros((1, m.nv), np.float32)
    g = g36.view(B, 2, 3, 6, nc).permute(0, 1, 4, 2, 3)
    return constraint.EfcSystem(
        lim_dof=lim_dof, lim_onehot=m.const(onehot, torch.float32),
        lim_sign=lim_sign, lim_aref=lim_aref, lim_D=lim_D, lim_pos=lim_pos,
        con_G1=g[:, 1], con_G2=g[:, 0], con_chain1=t["chain1"],
        con_chain2=t["chain2"], con_c1=m.const(t["chain1"], torch.float32),
        con_c2=m.const(t["chain2"], torch.float32), con_cdof=d.cdof,
        con_mu=con_mu(m, con_pair, B, dev), con_aref=con_aref, con_D=con_D,
        con_pos=pos, nlimit=len(lim_dof), ncon=nc, g36=g36)
