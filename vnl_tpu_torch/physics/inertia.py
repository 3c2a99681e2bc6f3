"""Composite rigid body mass matrix (PyTorch counterpart of
vnl_tpu/physics/inertia.py), batched over envs.  The inverses the step
needs come out of the position stage (kernel A, ops/position.py)."""

from __future__ import annotations

import numpy as np
import torch

from vnl_tpu_torch.physics.model import Data, DisableBit, IntegratorType, Model


def needs_implicit_damping(m: Model) -> bool:
    """Static: does the integrator need (M + h diag(B))^-1?  Euler honours
    the eulerdamp disable flag; implicitfast always solves implicitly."""
    key = "needs_implicit_damping"
    if key not in m.cache:
        damped = bool(np.any(m.dof_damping.cpu().numpy() != 0))
        if m.opt.integrator != int(IntegratorType.IMPLICITFAST):
            damped = damped and not (m.opt.disableflags
                                     & DisableBit.EULERDAMP)
        m.cache[key] = damped
    return m.cache[key]


def assemble_qM(m: Model, d: Data) -> torch.Tensor:
    """Dense joint-space mass matrix (B, nv, nv) from cinert/cdof (mj_crb)."""
    dtype = d.qpos.dtype
    B = d.qpos.shape[0]
    sub_mask = m.table("body_subtree_mask", dtype)
    crb = torch.einsum("bc,nck->nbk", sub_mask,
                       d.cinert.reshape(B, m.nbody, 36)).reshape(
                           B, m.nbody, 6, 6)
    F = torch.einsum("nvij,nvj->nvi", crb[:, m.index(m.dof_bodyid)], d.cdof)
    Ml = (F @ d.cdof.transpose(1, 2)) * m.table("dof_ancestor_mask", dtype)
    qM = Ml + Ml.transpose(1, 2) - torch.diag_embed(
        torch.diagonal(Ml, dim1=1, dim2=2))
    return qM + torch.diag(m.dof_armature.to(dtype))


def solve_m(d: Data, x: torch.Tensor) -> torch.Tensor:
    """qM y = x through the cached inverse: (B, nv) -> (B, nv)."""
    return torch.einsum("nij,nj->ni", d.qMinv, x)
