"""Forward dynamics and semi-implicit Euler integration (PyTorch
counterpart of vnl_tpu/physics/forward.py), batched over envs.

One substep: position stage (FK, com quantities, CRB mass matrix and its
inverses), collision, constraints, velocity stage, actuation, smooth
acceleration, the CG constraint solve (kernel B), then Euler with implicit
joint damping.  The position stage has two configurations: fused (kernel A
does all of it in one launch) and unfused (kinematics -> com_pos -> crb in
plain PyTorch, the exact inverses by kernel C or a refinement of the
carried ones).  RK4 and the implicit integrators are not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vnl_tpu_torch import math as vmath
from vnl_tpu_torch.ops import position as position_ops
from vnl_tpu_torch.physics import actuation as _actuation
from vnl_tpu_torch.physics import collision as _collision
from vnl_tpu_torch.physics import constraint as _constraint
from vnl_tpu_torch.physics import inertia as _inertia
from vnl_tpu_torch.physics import kinematics as _kinematics
from vnl_tpu_torch.physics import rne as _rne
from vnl_tpu_torch.physics import solver as _solver
from vnl_tpu_torch.physics.model import Data, IntegratorType, JointType, Model


def pin_fp32() -> None:
    """Physics runs in full fp32: no TF32 in matmuls or convolutions (the
    JAX package pins f32 for the same reason, forward.py:126-134)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_data(m: Model, batch: int, qpos: Optional[torch.Tensor] = None,
              qvel: Optional[torch.Tensor] = None,
              dtype=torch.float32) -> Data:
    """Fresh Data for ``batch`` envs at qpos0 (or the given state)."""
    nb, nv, dev = m.nbody, m.nv, m.device

    def z(*s):
        return torch.zeros((batch,) + s, dtype=dtype, device=dev)

    quat0 = z(nb, 4)
    quat0[..., 0] = 1.0
    eye = torch.eye(3, dtype=dtype, device=dev)
    return Data(
        qpos=(qpos.to(dtype) if qpos is not None
              else m.qpos0.to(dtype).expand(batch, -1).clone()),
        qvel=qvel.to(dtype) if qvel is not None else z(nv),
        act=z(m.na), ctrl=z(m.nu), xpos=z(nb, 3), xquat=quat0,
        xmat=eye.expand(batch, nb, 3, 3).clone(), xipos=z(nb, 3),
        xanchor=z(m.njnt, 3), xaxis=z(m.njnt, 3), geom_xpos=z(m.ngeom, 3),
        geom_xmat=eye.expand(batch, m.ngeom, 3, 3).clone(),
        subtree_com=z(nb, 3), cinert=z(nb, 6, 6), cdof=z(nv, 6),
        cvel=z(nb, 6), qM=z(nv, nv), qMinv=z(nv, nv), qMhBinv=z(nv, nv),
        qfrc_bias=z(nv), qfrc_passive=z(nv), qfrc_actuator=z(nv),
        actuator_force=z(m.nu), act_dot=z(m.na), qfrc_smooth=z(nv),
        qacc_smooth=z(nv), qfrc_constraint=z(nv), qacc=z(nv),
        contact_dist=z(m.ncon_max), contact_pos=z(m.ncon_max, 3),
        contact_frame=z(m.ncon_max, 3, 3), contact_force=z(m.ncon_max, 4))


def fwd_position(m: Model, d: Data, refine_inverse: bool = False,
                 fused_position: bool = True):
    """Position stage, collision and constraints.  ``fused_position``
    chooses kernel A (always exact) over the unfused stage, which alone
    reads ``refine_inverse`` (see inertia.crb)."""
    if fused_position:
        (xpos, xquat, xmat, xipos, xanchor, xaxis, gxp, gxm, scom, cinert,
         cdof, qM, *invs) = position_ops.position(m, d.qpos.contiguous())
        d = d.replace(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
                      xanchor=xanchor, xaxis=xaxis, geom_xpos=gxp,
                      geom_xmat=gxm, subtree_com=scom, cinert=cinert,
                      cdof=cdof, qM=qM, qMinv=invs[0], qMhBinv=invs[-1])
    else:
        d = _kinematics.kinematics(m, d)
        d = _kinematics.com_pos(m, d)
        d = _inertia.crb(m, d, refine_inverse=refine_inverse)
    con_dist, con_pos, con_frame, con_pair = _collision.collide(m, d)
    d = d.replace(contact_dist=con_dist, contact_pos=con_pos,
                  contact_frame=con_frame)
    efc = _constraint.make_constraints(m, d, con_dist, con_pos, con_frame,
                                       con_pair)
    return d, efc


def fwd_velocity(m: Model, d: Data) -> Data:
    cvel, cdof_dot = _rne.com_vel(m, d)
    return d.replace(cvel=cvel, qfrc_bias=_rne.rne(m, d, cvel, cdof_dot),
                     qfrc_passive=_rne.passive(m, d))


def forward(m: Model, d: Data, refine_inverse: bool = False,
            fused_position: bool = True) -> Data:
    """Full forward dynamics: derived fields and qacc.  ``refine_inverse``
    is valid when d is the previous substep's output."""
    pin_fp32()
    d, efc = fwd_position(m, d, refine_inverse, fused_position)
    d = fwd_velocity(m, d)
    force, qfrc_act, act_dot = _actuation.actuation(m, d)
    d = d.replace(actuator_force=force, qfrc_actuator=qfrc_act,
                  act_dot=act_dot)
    qfrc_smooth = d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
    qacc_smooth = _inertia.solve_m(d, qfrc_smooth)
    qacc, qfrc_constraint, con_force = _solver.solve(m, d, efc, qacc_smooth)
    if not efc.ncon:
        con_force = qacc.new_zeros(qacc.shape[0], m.ncon_max, 4)
    return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth,
                     qacc=qacc, qfrc_constraint=qfrc_constraint,
                     contact_force=con_force)


def _integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """qpos += dt qvel, with quaternion integration on free/ball joints."""
    hs = np.isin(m.jnt_type, (int(JointType.HINGE), int(JointType.SLIDE)))
    new = (qpos.index_add(1, m.index(m.jnt_qposadr[hs]),
                          dt * qvel[:, m.index(m.jnt_dofadr[hs])])
           if hs.any() else qpos.clone())
    for j in np.nonzero(~hs)[0]:
        qa, va = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
        if m.jnt_type[j] == JointType.FREE:
            new[:, qa:qa + 3] = qpos[:, qa:qa + 3] + dt * qvel[:, va:va + 3]
            new[:, qa + 3:qa + 7] = vmath.quat_integrate(
                qpos[:, qa + 3:qa + 7], qvel[:, va + 3:va + 6], dt)
        else:  # BALL
            new[:, qa:qa + 4] = vmath.quat_integrate(
                qpos[:, qa:qa + 4], qvel[:, va:va + 3], dt)
    return new


def integrate(m: Model, d: Data) -> Data:
    """Semi-implicit Euler with implicit joint damping (mj_Euler)."""
    dt = m.opt.timestep
    if _inertia.needs_implicit_damping(m):
        # qvel += dt (M + dt diag(B))^-1 M qacc
        dv = torch.einsum("nij,nj->ni", d.qMhBinv,
                          torch.einsum("nij,nj->ni", d.qM, d.qacc))
        qvel = d.qvel + dt * dv
    else:
        qvel = d.qvel + dt * d.qacc
    act = d.act + dt * d.act_dot if m.na else d.act
    return d.replace(qpos=_integrate_pos(m, d.qpos, qvel, dt), qvel=qvel,
                     act=act)


def step(m: Model, d: Data, refine_inverse: bool = False,
         fused_position: bool = True) -> Data:
    """One physics step: forward dynamics + Euler integration."""
    if m.opt.integrator not in (int(IntegratorType.EULER),
                                int(IntegratorType.IMPLICITFAST)):
        raise NotImplementedError(
            f"integrator {IntegratorType(m.opt.integrator).name} is not "
            "ported yet")
    return integrate(m, forward(m, d, refine_inverse, fused_position))
