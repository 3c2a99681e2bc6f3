"""Velocity products: com-frame body velocities, bias forces and passive
forces (PyTorch counterpart of vnl_tpu/physics/rne.py), batched.  Tree
prefix/suffix sums are products with the model's static ancestry masks."""

from __future__ import annotations

import numpy as np
import torch

from vnl_tpu_torch.math import spatial
from vnl_tpu_torch.physics import kinematics
from vnl_tpu_torch.physics.model import Data, DisableBit, JointType, Model


def com_vel(m: Model, d: Data):
    """Body spatial velocities (B, nbody, 6) and cdof time-derivatives."""
    dtype = d.qpos.dtype
    dof_vel = d.cdof * d.qvel[..., None]                        # (B, nv, 6)
    cvel = torch.einsum("bv,nvk->nbk",
                        m.table("body_chain_dof_mask", dtype), dof_vel)
    vel_snap = torch.einsum("iv,nvk->nik",
                            m.table("dof_prefix_mask", dtype), dof_vel)
    cdof_dot = spatial.motion_cross(vel_snap, d.cdof)
    # free-joint translation axes are constant world vectors
    is_free_t = kinematics.dof_tables(m)[0]
    return cvel, cdof_dot * m.const(~is_free_t, dtype)[:, None]


def rne(m: Model, d: Data, cvel, cdof_dot) -> torch.Tensor:
    """Bias force C(q, qvel): gravity + velocity products."""
    dtype = d.qpos.dtype
    grav = (np.zeros(3) if m.opt.disableflags & DisableBit.GRAVITY
            else np.asarray(m.opt.gravity))
    chain = m.table("body_chain_dof_mask", dtype)
    cacc = torch.einsum("bv,nvk->nbk", chain, cdof_dot * d.qvel[..., None])
    cacc = cacc + m.const(np.concatenate([np.zeros(3), -grav]), dtype)
    Iv = torch.einsum("nbij,nbj->nbi", d.cinert, cvel)
    f = (torch.einsum("nbij,nbj->nbi", d.cinert, cacc)
         + spatial.force_cross(cvel, Iv))
    f_sub = torch.einsum("bc,nck->nbk", m.table("body_subtree_mask", dtype), f)
    return torch.sum(d.cdof * f_sub[:, m.index(m.dof_bodyid)], -1)


def passive(m: Model, d: Data) -> torch.Tensor:
    """Joint spring/damper forces (mj_passive)."""
    if m.opt.disableflags & DisableBit.PASSIVE:
        return torch.zeros_like(d.qvel)
    qfrc = -m.dof_damping * d.qvel
    hs = np.isin(m.jnt_type, (int(JointType.HINGE), int(JointType.SLIDE)))
    if hs.any():
        jids = np.nonzero(hs)[0]
        qadr = m.index(m.jnt_qposadr[jids])
        frc = -m.jnt_stiffness[m.index(jids)] * (
            d.qpos[:, qadr] - m.qpos_spring[qadr])
        qfrc = qfrc.index_add(1, m.index(m.jnt_dofadr[jids]), frc)
    return qfrc
