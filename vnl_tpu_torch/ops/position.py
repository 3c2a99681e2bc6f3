"""Kernel A: the position stage (counterpart of
vnl_tpu/ops/pallas_position.py).

``position(m, qpos)`` maps a batch of qpos (B, nq) to the 13 or 14 outputs
of vnl_tpu/physics/forward.py:59 _position_reference: xpos, xquat, xmat,
xipos, xanchor, xaxis, geom_xpos, geom_xmat, subtree_com, cinert, cdof, qM,
qMinv and, for damped models, (qM + h diag(damping))^-1.  On a CUDA tensor
it launches the hand-written kernel csrc/position.cu; on a CPU tensor it
runs ``position_plain``, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vnl_tpu_torch.ops import build
from vnl_tpu_torch.ops.linalg import inv_spd
from vnl_tpu_torch.physics import inertia, kinematics
from vnl_tpu_torch.physics.model import Model, make_data

WARPS = 8           # warps that sweep one matrix (kWarps of the source; one
                    # block per env, two matrices when damped)
# (TR, TC) register tiles the kernel source instantiates: thread
# (warp, lane) of a matrix owns its rows warp + i * W, i < TR, and its
# columns lane + 32 * j, j < TC, where W is the number of warps that sweep
# one matrix: 1 for the one-warp route (TC = 1, nv <= TR <= 32: lane s
# holds column s), WARPS for the others.
WARP_TILES = ((16, 1), (32, 1))
TILE_SHAPES = WARP_TILES + ((10, 3), (12, 3))
OUTPUT_NAMES = ("xpos", "xquat", "xmat", "xipos", "xanchor", "xaxis",
                "geom_xpos", "geom_xmat", "subtree_com", "cinert", "cdof",
                "qM", "qMinv", "qMhBinv")


def output_shapes(m: Model):
    nb, nj, nv, ng = m.nbody, m.njnt, m.nv, m.ngeom
    shapes = [(nb, 3), (nb, 4), (nb, 3, 3), (nb, 3), (nj, 3), (nj, 3),
              (ng, 3), (ng, 3, 3), (nb, 3), (nb, 6, 6), (nv, 6), (nv, nv),
              (nv, nv)]
    return shapes + ([(nv, nv)] if inertia.needs_implicit_damping(m) else [])


def position_plain(m: Model, qpos: torch.Tensor):
    """Plain PyTorch position stage: kinematics, com_pos, CRB mass matrix
    and its inverse(s) by recursive Schur complements."""
    d = make_data(m, qpos.shape[0], qpos=qpos)
    d = kinematics.kinematics(m, d)
    d = kinematics.com_pos(m, d)
    qM = inertia.assemble_qM(m, d)
    outs = [d.xpos, d.xquat, d.xmat, d.xipos, d.xanchor, d.xaxis,
            d.geom_xpos, d.geom_xmat, d.subtree_com, d.cinert, d.cdof, qM]
    if inertia.needs_implicit_damping(m):
        hB = (m.opt.timestep * m.dof_damping).to(qpos.dtype)
        inv = inv_spd(torch.stack([qM, qM + torch.diag(hB)]))
        outs += [inv[0], inv[1]]
    else:
        outs += [inv_spd(qM)]
    return tuple(outs)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_INT_TABLES = ("body_parent", "body_jntadr", "body_jntnum", "body_rootid",
               "sub_start", "sub_body",
               "jnt_type", "jnt_qposadr", "geom_bodyid", "dof_bodyid",
               "dof_jntid", "anc_pair", "dof_kind", "dof_axis")
_FLOAT_TABLES = ("qpos0", "body_pos", "body_quat", "body_ipos", "body_iquat",
                 "body_mass", "body_inertia", "subtree_mass", "jnt_pos",
                 "jnt_axis", "geom_pos", "geom_quat", "armature", "hB")


class PosModel(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("nb", "nj", "nv", "nq", "ng",
                                             "damped", "nrounds", "npair")]
                + [(n, ctypes.c_void_p) for n in _INT_TABLES + _FLOAT_TABLES])


class PosOut(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in OUTPUT_NAMES]


def tile_warps(tr: int, tc: int) -> int:
    """Warps that sweep one matrix with the tile (TR, TC)."""
    return 1 if (tr, tc) in WARP_TILES else WARPS


def tile_shape(nv: int):
    """The first instantiated (TR, TC) tile that covers an nv x nv matrix
    (the one-warp route up to nv 32); ValueError where none does."""
    for tr, tc in TILE_SHAPES:
        if tile_warps(tr, tc) * tr >= nv and 32 * tc >= nv:
            return tr, tc
    raise ValueError(f"kernel A has no register tile for nv = {nv} "
                     f"(instantiated: {TILE_SHAPES})")


def route_name(m: Model) -> str:
    """The instantiation of kernel A that runs this model."""
    tr, tc = tile_shape(m.nv)
    nmat = 2 if inertia.needs_implicit_damping(m) else 1
    if (tr, tc) in WARP_TILES:
        return f"position_warp_kernel<{tr},{nmat}>"
    return f"position_kernel<{WARPS},{tr},{tc},{nmat}>"


def tile_map(nv: int, tr: int, tc: int) -> np.ndarray:
    """(threads, TR * TC, 2) int array: the (row, column) of every tile
    slot of every thread of the warps that sweep one matrix, -1 where the
    slot lies outside the matrix."""
    warps = tile_warps(tr, tc)
    tid = np.arange(warps * 32)
    r = (tid // 32)[:, None, None] + warps * np.arange(tr)[None, :, None]
    s = (tid % 32)[:, None, None] + 32 * np.arange(tc)[None, None, :]
    r, s = np.broadcast_arrays(r, s)
    rs = np.stack([r, s], -1).reshape(len(tid), tr * tc, 2)
    rs[(rs >= nv).any(-1)] = -1
    return rs


def kernel_tables(m: Model) -> dict:
    """Static numpy tables of kernel A for one model."""
    parent = np.asarray(m.body_parentid, np.int64)
    if np.any(parent[1:] >= np.arange(1, m.nbody)):
        raise ValueError("bodies are not in tree order (parent after child)")
    depth = np.zeros(m.nbody, np.int64)
    for b in range(1, m.nbody):
        depth[b] = depth[parent[b]] + 1
    # pointer doubling reaches the world from depth d in ceil(log2(d)) rounds
    nrounds = int(np.ceil(np.log2(max(int(depth.max()), 1))))
    is_free_t, is_local_rot, is_hinge, is_slide, axis_idx = \
        kinematics.dof_tables(m)
    kind = np.select([is_free_t, is_local_rot, is_hinge, is_slide],
                     [0, 1, 2, 3], -1)
    mass = m.body_mass.cpu().numpy().astype(np.float64)
    sub = np.asarray(m.body_subtree_mask, bool)     # [b, d]: d in subtree(b)
    sub_m = np.maximum(sub @ mass, 1e-12)
    if not sub.diagonal().all() or np.tril(sub, -1).any():
        raise ValueError("a body's subtree must hold itself and only later "
                         "bodies")
    sub_start = np.concatenate([[0], np.cumsum(sub.sum(1))])
    sub_body = np.nonzero(sub)[1]                   # row-major: ascending
    anc = np.asarray(m.dof_ancestor_mask, bool)     # [i, j]: j above-or-is i
    if np.triu(anc, 1).any() or m.nv > 0xffff:
        raise ValueError("dof ancestors must precede their dofs")
    pi, pj = np.nonzero(anc)
    anc_pair = (pi << 16) | pj
    damping = m.dof_damping.cpu().numpy().astype(np.float64)
    ints = dict(
        body_parent=parent, body_jntadr=m.body_jntadr,
        body_jntnum=m.body_jntnum, body_rootid=m.body_rootid,
        sub_start=sub_start, sub_body=sub_body, jnt_type=m.jnt_type, jnt_qposadr=m.jnt_qposadr,
        geom_bodyid=m.geom_bodyid, dof_bodyid=m.dof_bodyid,
        dof_jntid=m.dof_jntid, anc_pair=anc_pair, dof_kind=kind,
        dof_axis=axis_idx)
    floats = dict(
        qpos0=m.qpos0, body_pos=m.body_pos, body_quat=m.body_quat,
        body_ipos=m.body_ipos, body_iquat=m.body_iquat, body_mass=m.body_mass,
        body_inertia=m.body_inertia, subtree_mass=sub_m,
        jnt_pos=m.jnt_pos, jnt_axis=m.jnt_axis, geom_pos=m.geom_pos,
        geom_quat=m.geom_quat, armature=m.dof_armature,
        hB=m.opt.timestep * damping)
    return dict(nrounds=nrounds, depth=depth, ints=ints, floats=floats)


def _device_model(m: Model, device: torch.device) -> PosModel:
    """PosModel struct with the tables on ``device``, made once per model."""
    def make(device):
        t = kernel_tables(m)
        held = dict(build.on_device(t["ints"], device, np.int32),
                    **build.on_device(t["floats"], device, np.float32))
        return PosModel(nb=m.nbody, nj=m.njnt, nv=m.nv, nq=m.nq, ng=m.ngeom,
                        damped=int(inertia.needs_implicit_damping(m)),
                        nrounds=t["nrounds"],
                        npair=len(t["ints"]["anc_pair"]),
                        **{n: held[n].data_ptr() for n in held}), held
    return build.tables(m, "position", device, make)


def resources(m: Model) -> dict:
    """Registers per thread, local (spill) bytes, shared memory per block
    and resident blocks per SM of kernel A for this model."""
    tr, tc = tile_shape(m.nv)
    nmat = 2 if inertia.needs_implicit_damping(m) else 1
    return dict(build.resources("position", _device_model(m, m.device),
                                tr, tc),
                threads=32 * tile_warps(tr, tc) * nmat, route=route_name(m))


_ARGTYPES = (PosModel, ctypes.c_void_p, PosOut, ctypes.c_int, ctypes.c_int,
             ctypes.c_int)


def _launch(m: Model, qpos: torch.Tensor, skip: int = 0):
    """Launches kernel A.  ``skip`` is for profiling only (the outputs are
    then wrong): bit 0 leaves out the sweeps, bit 1 the subtree sums, bit
    2 the doubling rounds of the tree walk, bit 3 the assembly of qM."""
    B = qpos.shape[0]
    build.check_inputs("position", m.device, (B,), ("qpos", qpos, (m.nq,)))
    tr, tc = tile_shape(m.nv)
    outs = [torch.empty((B,) + s, device=qpos.device, dtype=torch.float32)
            for s in output_shapes(m)]
    ptrs = [o.data_ptr() for o in outs]
    ptrs += [ptrs[-1]] * (len(OUTPUT_NAMES) - len(ptrs))
    build.launch("position", _ARGTYPES, qpos.device,
                  _device_model(m, qpos.device), qpos.data_ptr(),
                  PosOut(*ptrs), B, tr, tc, skip=skip)
    return tuple(outs)


def position(m: Model, qpos: torch.Tensor):
    """The position stage of a batch: kernel A on a CUDA tensor, the plain
    version elsewhere."""
    return _launch(m, qpos) if qpos.is_cuda else position_plain(m, qpos)
