"""Kernel B: the whole CG contact solve (counterpart of
vnl_tpu/ops/pallas_cg.py).

``solve(m, d, efc, qacc_smooth)`` is forward's constraint solve: where the
system is kernel B's (the CG solver on a factored system with contacts)
it packs it by ``cg_inputs`` into the flat per-env signature of the JAX
package's make_cg_fused, batched on a leading dim:
  qM, qMinv (B, nv, nv), qacc_smooth (B, nv), cdof (B, nv, 6),
  g36 (B, 36, ncon) [G2 | G1 rows, f-major], lim_sign/aref/D (B, nlimit),
  con_mu (B, ncon, 2), con_aref/con_D (B, ncon, 4)
  -> qacc (B, nv), qfrc_constraint (B, nv), con_f (B, ncon, 4),
and launches csrc/cg.cu on CUDA tensors or runs ``cg_plain`` on CPU
tensors, the port of vnl_tpu/physics/solver.py:215 _make_cg_reference
(the same solve, recomputing M(x - a) each iteration); every other system
goes to physics/solver.py solve.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from vnl_tpu_torch.ops import build, capture_notes, launch_counts
from vnl_tpu_torch.physics import constraint, solver
from vnl_tpu_torch.physics.model import Data, Model, SolverType

THREADS = 256       # kThreads of the source: one block per env
_STATICS: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class CgStatics:
    """Static structure of one model's constraint system."""

    nv: int
    ncon: int
    nlimit: int
    lim_dof: np.ndarray      # (nlimit,)
    chain1: np.ndarray       # (ncon, nv) 0/1
    chain2: np.ndarray       # (ncon, nv) 0/1
    iters: int
    ls_iters: int
    cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def make(nv, lim_dof, chain1, chain2, iters, ls_iters) -> "CgStatics":
        lim_dof = np.asarray(lim_dof, np.int32)
        chain1 = np.asarray(chain1, np.float32)
        chain2 = np.asarray(chain2, np.float32)
        key = (nv, iters, ls_iters, lim_dof.tobytes(), chain1.tobytes(),
               chain2.tobytes())
        if key not in _STATICS:
            _STATICS[key] = CgStatics(nv, chain1.shape[0], len(lim_dof),
                                      lim_dof, chain1, chain2, iters,
                                      ls_iters)
        return _STATICS[key]


def _efc(st: CgStatics, cdof, g36, lim_sign, lim_aref, lim_D, con_mu,
         con_aref, con_D) -> constraint.EfcSystem:
    B, dtype, dev = cdof.shape[0], cdof.dtype, cdof.device
    g = g36.reshape(B, 2, 3, 6, st.ncon).permute(0, 1, 4, 2, 3)
    z = lim_sign.new_zeros
    return constraint.EfcSystem(
        lim_dof=st.lim_dof,
        lim_onehot=torch.as_tensor(
            constraint.limit_onehot(st.lim_dof, st.nv), dtype=dtype,
            device=dev),
        lim_sign=lim_sign, lim_aref=lim_aref, lim_D=lim_D,
        lim_pos=z(lim_sign.shape), con_G1=g[:, 1], con_G2=g[:, 0],
        con_chain1=st.chain1, con_chain2=st.chain2,
        con_c1=torch.as_tensor(st.chain1, dtype=dtype, device=dev),
        con_c2=torch.as_tensor(st.chain2, dtype=dtype, device=dev),
        con_cdof=cdof, con_mu=con_mu, con_aref=con_aref, con_D=con_D,
        con_pos=z(B, st.ncon), nlimit=st.nlimit, ncon=st.ncon)


def cg_plain(qM, qMinv, qacc_smooth, cdof, g36, lim_sign, lim_aref, lim_D,
             con_mu, con_aref, con_D, *, statics: CgStatics):
    """Plain PyTorch CG solve (solver._cg_loop over the factored system)."""
    efc = _efc(statics, cdof, g36, lim_sign, lim_aref, lim_D, con_mu,
               con_aref, con_D)
    x, lim_jx, con_fx = solver._cg_loop(qM, qMinv, efc, qacc_smooth,
                                        statics.iters, statics.ls_iters)
    _, _, lim_f, con_f = solver._forces(efc, lim_jx, con_fx)
    return x, efc.jt_f(lim_f, con_f), con_f


def kernel_b_system(m: Model, efc: constraint.EfcSystem
                    ) -> constraint.EfcSystem:
    """The system as kernel B takes it: a contact-only model gets one inert
    limit row (sign 0, D 0), which keeps the kernel's shapes non-empty
    (solver.py:253-263 in the JAX package)."""
    if efc.nlimit:
        return efc
    z = efc.con_cdof.new_zeros(efc.con_cdof.shape[0], 1)
    return efc.replace(lim_dof=np.zeros(1, np.int32),
                       lim_onehot=efc.con_cdof.new_zeros(1, m.nv),
                       lim_sign=z, lim_aref=z, lim_D=z, lim_pos=z, nlimit=1)


def g36(efc: constraint.EfcSystem) -> torch.Tensor:
    """Kernel B's (B, 36, ncon) moment arms [G2 | G1 rows, f-major]: kernel
    D's own where it built the system, else packed from G1 and G2."""
    if efc.g36 is not None:
        return efc.g36
    return torch.cat([
        efc.con_G2.permute(0, 2, 3, 1).reshape(-1, 18, efc.ncon),
        efc.con_G1.permute(0, 2, 3, 1).reshape(-1, 18, efc.ncon)],
        1).contiguous()


def cg_inputs(m: Model, d: Data, efc: constraint.EfcSystem, qacc_smooth,
              n_iter: int):
    """The flat arguments and static structure of the CG solve (the
    signature of ``cg_plain`` and of kernel B)."""
    efc = kernel_b_system(m, efc)
    args = (d.qM, d.qMinv, qacc_smooth.contiguous(), efc.con_cdof,
            g36(efc), efc.lim_sign, efc.lim_aref, efc.lim_D,
            efc.con_mu.contiguous(), efc.con_aref, efc.con_D)
    statics = CgStatics.make(m.nv, efc.lim_dof, efc.con_chain1,
                             efc.con_chain2, n_iter,
                             max(m.opt.ls_iterations, 1))
    return args, statics


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_IN = ("qM", "qMinv", "x0", "cdof", "g36", "lim_sign", "lim_aref", "lim_D",
       "con_mu", "con_aref", "con_D")


_TABLES = ("lim_dof", "lim_of_dof", "side_start", "side_dof", "dof_start",
           "dof_side")
_WIDE_TABLES = ("lim_dof", "lim_of_dof", "side_start", "side_dof",
                "dof_start", "dof_side", "grp_start", "grp_dof",
                "grp_of_side", "chunk_start", "chunk_side", "dof_cstart",
                "dof_chunk")
_SIZES = ("nv", "ncon", "nlimit", "iters", "ls_iters")


class CgModel(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in _SIZES] + \
               [(n, ctypes.c_void_p) for n in _TABLES]


class CgWide(ctypes.Structure):
    """The wide route's model (CgWide of the source): CgModel's fields,
    the group and chunk counts after its sizes, the per-body tables."""
    _fields_ = [(n, ctypes.c_int) for n in _SIZES + ("ngrp", "nchunk")] + \
               [(n, ctypes.c_void_p) for n in _WIDE_TABLES]


def kernel_tables(st: CgStatics) -> dict:
    """Static int tables of kernel B.  Sides are numbered sd * ncon + c with
    sd 0 for chain2 (added) and sd 1 for chain1 (subtracted):
      lim_of_dof (nv): the limit row of each dof, -1 where it has none;
      side_start, side_dof: per side, the dofs of its chain (CSR);
      dof_start, dof_side: per dof, the sides whose chain holds it (CSR),
        ordered by contact and, within one contact, chain2 before chain1.
    The route for wide systems groups the sides by their chain (a chain is
    that of a body, so a group is a body that carries contacts; the empty
    chain of the world is no group) and adds ``body_tables``:
      grp_start, grp_dof: per group, the dofs of its chain, ascending;
      grp_of_side (2 ncon): the group of each side, ngrp for an empty one;
      chunk_start, chunk_side: each group's sides, ascending, cut into
        chunks of at most ``chunk_len`` sides (one thread a chunk and
        spatial component: chunk_len is the least that gives no more
        chunks than THREADS / 6);
      dof_cstart, dof_chunk: per dof, the chunks whose chain holds it,
        ascending (the chunks of the bodies below the dof's body).
    """
    lim_of_dof = np.full(st.nv, -1, np.int32)
    lim_of_dof[st.lim_dof] = np.arange(st.nlimit)
    if len(np.unique(st.lim_dof)) != st.nlimit:
        raise ValueError("kernel B takes at most one limit row per dof")
    sides = np.concatenate([st.chain2, st.chain1]) != 0     # (2 ncon, nv)
    side_start = np.concatenate([[0], np.cumsum(sides.sum(1))])
    side_dof = np.nonzero(sides)[1]
    # per dof: contacts ascending, chain2 before chain1
    by_contact = sides.reshape(2, st.ncon, st.nv).transpose(2, 1, 0)
    dof_start = np.concatenate([[0], np.cumsum(sides.sum(0))])
    d, c, sd = np.nonzero(by_contact)
    return dict(lim_dof=st.lim_dof, lim_of_dof=lim_of_dof,
                side_start=side_start, side_dof=side_dof,
                dof_start=dof_start, dof_side=sd * st.ncon + c,
                **body_tables(sides))


def _csr(lists):
    start = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    flat = np.concatenate([np.asarray(x, np.int64) for x in lists]) \
        if lists else np.zeros(0, np.int64)
    return start, flat


def body_tables(sides: np.ndarray) -> dict:
    """The per-body tables of kernel B's wide route (see kernel_tables)
    from the (2 ncon, nv) 0/1 chain masks of the sides."""
    nside, nv = sides.shape
    chains, grp_of_side = [], np.zeros(nside, np.int64)
    index = {}
    for sc in range(nside):
        key = np.flatnonzero(sides[sc]).tobytes()
        if not sides[sc].any():
            grp_of_side[sc] = -1
            continue
        if key not in index:
            index[key] = len(chains)
            chains.append(np.flatnonzero(sides[sc]))
        grp_of_side[sc] = index[key]
    ngrp = len(chains)
    grp_of_side[grp_of_side < 0] = ngrp
    members = [np.flatnonzero(grp_of_side == g) for g in range(ngrp)]
    counts = [len(x) for x in members]
    chunk_len = 1
    while sum(-(-n // chunk_len) for n in counts) * 6 > THREADS and \
            chunk_len < max(counts, default=1):
        chunk_len += 1
    chunks, chunk_grp = [], []
    for g, own in enumerate(members):
        for i in range(0, len(own), chunk_len):
            chunks.append(own[i:i + chunk_len])
            chunk_grp.append(g)
    grp_mask = np.zeros((ngrp, nv), bool)
    for g, dofs in enumerate(chains):
        grp_mask[g, dofs] = True
    chunk_grp = np.asarray(chunk_grp, np.int64)
    dof_chunks = [np.flatnonzero(grp_mask[chunk_grp, d]) if len(chunk_grp)
                  else np.zeros(0, np.int64) for d in range(nv)]
    grp_start, grp_dof = _csr(chains)
    chunk_start, chunk_side = _csr(chunks)
    dof_cstart, dof_chunk = _csr(dof_chunks)
    return dict(grp_start=grp_start, grp_dof=grp_dof,
                grp_of_side=grp_of_side, chunk_start=chunk_start,
                chunk_side=chunk_side, dof_cstart=dof_cstart,
                dof_chunk=dof_chunk, chunk_len=chunk_len)


class CgIn(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _IN]


class CgOut(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("qacc", "qfrc", "con_f")]


def _device_model(st: CgStatics, device: torch.device):
    """(CgModel, CgWide) with the tables on ``device``, made once."""
    def make(device):
        t = kernel_tables(st)
        held = build.on_device({n: t[n] for n in _TABLES + _WIDE_TABLES},
                                device, np.int32)
        sizes = [getattr(st, n) for n in _SIZES]
        return (CgModel(*sizes, *[held[n].data_ptr() for n in _TABLES]),
                CgWide(*sizes, len(t["grp_start"]) - 1,
                       len(t["chunk_start"]) - 1,
                       *[held[n].data_ptr() for n in _WIDE_TABLES])), held
    return build.tables(st, "cg", device, make)


WIDE_SLOTS = (1, 2, 3, 4)   # contact-row slots a thread of the wide route
                            # holds (cg_wide_kernel<NCS, 1> instantiations)


def kernel_name(st: CgStatics) -> str:
    """The route of kernel B that runs this system (pick_kernel of the
    source): up to 160 constraint rows, the line search on one warp with 5
    rows a lane in registers (the twin's route); up to 1,024 contact rows
    and 256 limit rows, the wide route, every row in a register of one of
    the block's 256 threads; wider, the line search from shared memory."""
    rows = st.nlimit + 4 * st.ncon
    if rows <= 32 * 5:
        return "cg_kernel<5>"
    slots = -(-4 * st.ncon // THREADS)
    if slots <= max(WIDE_SLOTS) and st.nlimit <= THREADS:
        return f"cg_wide_kernel<{slots},1>"
    return "cg_kernel<0>"


def resources(st: CgStatics, device="cuda") -> dict:
    """Registers per thread, local (spill) bytes, shared memory per block
    and resident blocks per SM of kernel B for this constraint system."""
    return dict(build.resources("cg", *_device_model(st,
                                                     torch.device(device))),
                threads=THREADS, route=kernel_name(st))


_ARGTYPES = (CgModel, CgWide, CgIn, CgOut, ctypes.c_int)


def _launch(st: CgStatics, args, skip: int = 0):
    """Launches kernel B.  ``skip`` is for profiling only (the outputs are
    then wrong): bit 0 empties the chain lists of J v (the groups' on the
    wide route), bit 1 those of J^T f (the chunks' and the dofs' chunk
    lists), bit 2 leaves out the matvecs' inner loops."""
    B = args[0].shape[0]
    nv, nc, nl = st.nv, st.ncon, st.nlimit
    shapes = [(nv, nv), (nv, nv), (nv,), (nv, 6), (36, nc), (nl,), (nl,),
              (nl,), (nc, 2), (nc, 4), (nc, 4)]
    dev = args[0].device
    build.check_inputs("cg", dev, (B,), *zip(_IN, args, shapes))
    if nl == 0 or nc == 0:
        raise ValueError("kernel B needs at least one limit row and one "
                         "contact")
    if nv > 32 * (THREADS // 32 - 1):
        raise ValueError(f"kernel B gives every dof a thread of its "
                         f"{THREADS} and keeps a warp free: nv = {nv}")
    qacc = torch.empty(B, nv, device=dev)
    qfrc = torch.empty(B, nv, device=dev)
    con_f = torch.empty(B, nc, 4, device=dev)
    build.launch("cg", _ARGTYPES, dev, *_device_model(st, dev),
                  CgIn(*[a.data_ptr() for a in args]),
                  CgOut(qacc.data_ptr(), qfrc.data_ptr(), con_f.data_ptr()),
                  B, skip=skip)
    if kernel_name(st) == "cg_kernel<0>":   # the widest route, by itself
        launch_counts["cg_widest"] += 1
    capture_notes["solve_rows"] = nl + 4 * nc
    return qacc, qfrc, con_f


def solve(m: Model, d: Data, efc: constraint.EfcSystem,
          qacc_smooth: torch.Tensor):
    """forward's constraint solve: (qacc, qfrc_constraint, contact forces).
    Kernel B's whole solve where the system is its (CG on a factored
    system with contacts), on CUDA tensors, and its plain version on CPU
    tensors; solver.solve for every other system (Newton, the dense
    Jacobian of the elliptic cone, no contacts)."""
    if (m.opt.solver == int(SolverType.NEWTON) or efc.con_Jc is not None
            or not efc.ncon):
        return solver.solve(m, d, efc, qacc_smooth)
    args, statics = cg_inputs(m, d, efc, qacc_smooth,
                              max(m.opt.iterations, 1))
    if args[0].is_cuda:
        return _launch(statics, args)
    return cg_plain(*args, statics=statics)
