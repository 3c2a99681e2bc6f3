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

from vnl_tpu_torch.ops import build, launch_counts
from vnl_tpu_torch.ops.linalg import inv_spd
from vnl_tpu_torch.physics import inertia, kinematics
from vnl_tpu_torch.physics.model import Model

THREADS = 256
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
    from vnl_tpu_torch.physics.forward import make_data
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
               "level_start", "level_body", "jnt_type", "jnt_qposadr",
               "jnt_bodyid", "geom_bodyid", "dof_bodyid", "dof_jntid",
               "dof_parent", "dof_kind", "dof_axis")
_FLOAT_TABLES = ("qpos0", "body_pos", "body_quat", "body_ipos", "body_iquat",
                 "body_mass", "body_inertia", "subtree_mass", "jnt_pos",
                 "jnt_axis", "geom_pos", "geom_quat", "armature", "hB")


class PosModel(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("nb", "nj", "nv", "nq", "ng",
                                             "damped", "nlevel")]
                + [(n, ctypes.c_void_p) for n in _INT_TABLES + _FLOAT_TABLES])


class PosOut(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in OUTPUT_NAMES]


def dof_parent(m: Model) -> np.ndarray:
    """Parent dof of each dof (-1 at a root), from the ancestor mask."""
    anc = np.asarray(m.dof_ancestor_mask, bool)
    parent = np.full(m.nv, -1, np.int32)
    for i in range(m.nv):
        prev = np.nonzero(anc[i, :i])[0]
        if len(prev):
            parent[i] = prev[-1]
            chain = anc[parent[i]].copy()
            chain[i] = True
            if not np.array_equal(chain, anc[i]):
                raise ValueError(f"dof {i}: ancestry is not a chain")
    return parent


def kernel_tables(m: Model) -> dict:
    """Static numpy tables of kernel A for one model."""
    parent = np.asarray(m.body_parentid, np.int64)
    if np.any(parent[1:] >= np.arange(1, m.nbody)):
        raise ValueError("bodies are not in tree order (parent after child)")
    depth = np.zeros(m.nbody, np.int64)
    for b in range(1, m.nbody):
        depth[b] = depth[parent[b]] + 1
    order = np.argsort(depth[1:], kind="stable") + 1
    nlevel = int(depth.max())
    level_start = np.searchsorted(depth[order], np.arange(1, nlevel + 2))
    is_free_t, is_local_rot, is_hinge, is_slide, axis_idx = \
        kinematics.dof_tables(m)
    kind = np.select([is_free_t, is_local_rot, is_hinge, is_slide],
                     [0, 1, 2, 3], -1)
    mass = m.body_mass.cpu().numpy().astype(np.float64)
    sub_m = np.maximum(np.asarray(m.body_subtree_mask) @ mass, 1e-12)
    damping = m.dof_damping.cpu().numpy().astype(np.float64)
    ints = dict(
        body_parent=parent, body_jntadr=m.body_jntadr,
        body_jntnum=m.body_jntnum, body_rootid=m.body_rootid,
        level_start=level_start, level_body=order, jnt_type=m.jnt_type,
        jnt_qposadr=m.jnt_qposadr, jnt_bodyid=m.jnt_bodyid,
        geom_bodyid=m.geom_bodyid, dof_bodyid=m.dof_bodyid,
        dof_jntid=m.dof_jntid, dof_parent=dof_parent(m), dof_kind=kind,
        dof_axis=axis_idx)
    floats = dict(
        qpos0=m.qpos0, body_pos=m.body_pos, body_quat=m.body_quat,
        body_ipos=m.body_ipos, body_iquat=m.body_iquat, body_mass=m.body_mass,
        body_inertia=m.body_inertia, subtree_mass=sub_m,
        jnt_pos=m.jnt_pos, jnt_axis=m.jnt_axis, geom_pos=m.geom_pos,
        geom_quat=m.geom_quat, armature=m.dof_armature,
        hB=m.opt.timestep * damping)
    return dict(nlevel=nlevel, ints=ints, floats=floats)


def _device_model(m: Model, device: torch.device):
    """PosModel struct with the tables on ``device``, made once per model."""
    key = ("position_kernel", str(device))
    if key not in m.cache:
        t = kernel_tables(m)
        held = {}
        for n, a in t["ints"].items():
            a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
            held[n] = torch.as_tensor(a.astype(np.int32), device=device)
        for n, a in t["floats"].items():
            a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
            held[n] = torch.as_tensor(a.astype(np.float32),
                                      device=device).contiguous()
        st = PosModel(nb=m.nbody, nj=m.njnt, nv=m.nv, nq=m.nq, ng=m.ngeom,
                      damped=int(inertia.needs_implicit_damping(m)),
                      nlevel=t["nlevel"],
                      **{n: held[n].data_ptr() for n in held})
        m.cache[key] = (st, held)
    return m.cache[key][0]


def _launch(m: Model, qpos: torch.Tensor):
    if qpos.dtype != torch.float32 or qpos.dim() != 2 or \
            qpos.shape[1] != m.nq or not qpos.is_contiguous():
        raise ValueError(f"kernel A takes contiguous float32 (B, {m.nq}) "
                         f"qpos, got {qpos.dtype} {tuple(qpos.shape)}")
    if qpos.device != m.device:
        raise ValueError(f"qpos on {qpos.device}, model on {m.device}")
    lib = build.load("position")
    fn = lib.position_launch
    fn.argtypes = [PosModel, ctypes.c_void_p, PosOut, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B = qpos.shape[0]
    outs = [torch.empty((B,) + s, device=qpos.device, dtype=torch.float32)
            for s in output_shapes(m)]
    ptrs = [o.data_ptr() for o in outs]
    ptrs += [ptrs[-1]] * (len(OUTPUT_NAMES) - len(ptrs))
    st = _device_model(m, qpos.device)
    stream = torch.cuda.current_stream(qpos.device).cuda_stream
    build.check(fn(st, qpos.data_ptr(), PosOut(*ptrs), B, THREADS, stream),
                "kernel A (position)")
    launch_counts["position"] += 1
    return tuple(outs)


def position(m: Model, qpos: torch.Tensor):
    """The position stage of a batch: kernel A on a CUDA tensor, the plain
    version on a CPU tensor."""
    if qpos.is_cuda:
        return _launch(m, qpos)
    if qpos.device.type != "cpu":
        raise ValueError(f"no position stage for device {qpos.device}")
    return position_plain(m, qpos)
