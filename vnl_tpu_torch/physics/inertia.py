"""Composite rigid body mass matrix and its inverses (PyTorch counterpart
of vnl_tpu/physics/inertia.py), batched over envs.  In the fused position
stage the inverses come out of kernel A (ops/position.py); in the unfused
stage ``crb`` assembles qM and ``invert_mass_matrix`` inverts it exactly
with kernel C (ops/sweep.py) or refines the carried inverses
(ops/linalg.py refine_inv)."""

from __future__ import annotations

import numpy as np
import torch

from vnl_tpu_torch.ops.linalg import refine_inv
from vnl_tpu_torch.ops.sweep import inv_spd_fused
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


def crb(m: Model, d: Data, refine_inverse: bool = False) -> Data:
    """The dense mass matrix qM and both inverses the step needs: qM^-1
    (smooth acceleration, CG preconditioner) and (qM + h diag(B))^-1
    (implicit joint damping in the Euler integrator).

    refine_inverse: qM depends only on qpos, which drifts little between
    the substeps of one control step, so pipeline_step inverts exactly on
    the first substep only and polishes the carried inverses on the
    others."""
    return invert_mass_matrix(m, d.replace(qM=assemble_qM(m, d)),
                              refine_inverse)


def invert_mass_matrix(m: Model, d: Data,
                       refine_inverse: bool = False) -> Data:
    """Fills qMinv / qMhBinv from d.qM: one exact inverse of the stack
    [qM, qM + h diag(B)] (one kernel C launch for both), or two
    Newton-Schulz steps on the carried pair.  h diag(B) is no small
    perturbation of qM, so (qM + h B)^-1 is refined from its own previous
    value, never from qM^-1.  An undamped model has one matrix."""
    qM = d.qM
    if not needs_implicit_damping(m):
        inv = (refine_inv(qM, d.qMinv) if refine_inverse
               else inv_spd_fused(qM.contiguous()))
        return d.replace(qMinv=inv, qMhBinv=inv)
    hB = (m.opt.timestep * m.dof_damping).to(qM.dtype)
    stacked = torch.stack([qM, qM + torch.diag(hB)])
    if refine_inverse:
        inv = refine_inv(stacked, torch.stack([d.qMinv, d.qMhBinv]))
    else:
        inv = inv_spd_fused(stacked)
    return d.replace(qMinv=inv[0], qMhBinv=inv[1])


def solve_m(d: Data, x: torch.Tensor) -> torch.Tensor:
    """qM y = x through the cached inverse: (B, nv) -> (B, nv)."""
    return torch.einsum("nij,nj->ni", d.qMinv, x)
