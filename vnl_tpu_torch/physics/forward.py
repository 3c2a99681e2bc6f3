"""Forward dynamics and integration (PyTorch counterpart of
vnl_tpu/physics/forward.py), batched over envs.

One substep: position stage (FK, com quantities, CRB mass matrix and its
inverses), collision, constraints, velocity stage, actuation, smooth
acceleration, the constraint solve (kernel B for CG, solver.py), optional
sensors, then the model's integrator: Euler with implicit joint damping
(implicitfast takes the same path), RK4 (three more forward passes a
step) or full implicit ((M - h qDeriv)^-1 with qDeriv the
torch.func.jacfwd of the velocity-dependent forces).  The position stage
has two configurations: fused (kernel A does all of it in one launch, in
every forward pass, RK4's included) and unfused (kinematics -> com_pos ->
crb in plain PyTorch, the exact inverses by kernel C or a refinement of
the carried ones).

This is the one module of physics/ that calls the kernels bound to a
Model: ops/position.py position, ops/collision.py collide,
ops/constraints.py system and ops/cg.py solve, each of which runs its
kernel on a CUDA device and the plain version of physics/ elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from vnl_tpu_torch import math as vmath
from vnl_tpu_torch.ops import cg as cg_ops
from vnl_tpu_torch.ops import collision as collision_ops
from vnl_tpu_torch.ops import constraints as constraint_ops
from vnl_tpu_torch.ops import position as position_ops
from vnl_tpu_torch.ops.linalg import refine_inv_general
from vnl_tpu_torch.physics import actuation as _actuation
from vnl_tpu_torch.physics import inertia as _inertia
from vnl_tpu_torch.physics import kinematics as _kinematics
from vnl_tpu_torch.physics import rne as _rne
from vnl_tpu_torch.physics import sensor as _sensor
# make_data lives beside Data (physics/model.py); it keeps its name here
from vnl_tpu_torch.physics.model import (Data, IntegratorType, JointType,
                                         Model, make_data)
from vnl_tpu_torch.utils.profiler import part


def pin_fp32() -> None:
    """Physics runs in full fp32: no TF32 in matmuls or convolutions (the
    JAX package pins f32 for the same reason, forward.py:126-134)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fwd_position(m: Model, d: Data, refine_inverse: bool = False,
                 fused_position: bool = True):
    """Position stage, collision and constraints.  ``fused_position``
    chooses kernel A (always exact) over the unfused stage, which alone
    reads ``refine_inverse`` (see inertia.crb)."""
    with part("position"):
        if fused_position:
            (xpos, xquat, xmat, xipos, xanchor, xaxis, gxp, gxm, scom,
             cinert, cdof, qM, *invs) = position_ops.position(
                 m, d.qpos.contiguous())
            d = d.replace(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
                          xanchor=xanchor, xaxis=xaxis, geom_xpos=gxp,
                          geom_xmat=gxm, subtree_com=scom, cinert=cinert,
                          cdof=cdof, qM=qM, qMinv=invs[0], qMhBinv=invs[-1])
        else:
            d = _kinematics.kinematics(m, d)
            d = _kinematics.com_pos(m, d)
            d = _inertia.crb(m, d, refine_inverse=refine_inverse)
    with part("collision"):
        con_dist, con_pos, con_frame, con_pair = collision_ops.collide(m, d)
    d = d.replace(contact_dist=con_dist, contact_pos=con_pos,
                  contact_frame=con_frame)
    with part("constraints"):
        efc = constraint_ops.system(m, d, con_dist, con_pos, con_frame,
                                    con_pair)
    return d, efc


def fwd_velocity(m: Model, d: Data) -> Data:
    cvel, cdof_dot = _rne.com_vel(m, d)
    return d.replace(cvel=cvel, qfrc_bias=_rne.rne(m, d, cvel, cdof_dot),
                     qfrc_passive=_rne.passive(m, d))


def forward(m: Model, d: Data, refine_inverse: bool = False,
            fused_position: bool = True,
            compute_sensors: bool = False) -> Data:
    """Full forward dynamics: derived fields and qacc.  ``refine_inverse``
    is valid when d is the previous substep's output; ``compute_sensors``
    evaluates the model's sensors into d.sensordata (off by default, as in
    the JAX package: the envs read the state directly)."""
    pin_fp32()
    d, efc = fwd_position(m, d, refine_inverse, fused_position)
    with part("velocity"):                  # and actuation, M^-1 qfrc
        d = fwd_velocity(m, d)
        force, qfrc_act, act_dot = _actuation.actuation(m, d)
        d = d.replace(actuator_force=force, qfrc_actuator=qfrc_act,
                      act_dot=act_dot)
        qfrc_smooth = d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
        qacc_smooth = _inertia.solve_m(d, qfrc_smooth)
    with part("solve"):
        qacc, qfrc_constraint, con_force = cg_ops.solve(m, d, efc,
                                                        qacc_smooth)
        if not efc.ncon:
            con_force = qacc.new_zeros(qacc.shape[0], m.ncon_max, 4)
        elif con_force.shape[-1] == 3:             # elliptic rows -> pad
            con_force = torch.nn.functional.pad(con_force, (0, 1))
    d = d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth,
                  qacc=qacc, qfrc_constraint=qfrc_constraint,
                  contact_force=con_force)
    if compute_sensors and m.nsensordata:
        d = d.replace(sensordata=_sensor.sensors(m, d))
    return d


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


def _vel_forces(m: Model, d: Data, qvel: torch.Tensor) -> torch.Tensor:
    """Velocity-dependent smooth forces at (d.qpos, qvel): passive
    - bias + actuator."""
    d2 = d.replace(qvel=qvel)
    cvel, cdof_dot = _rne.com_vel(m, d2)
    qfrc_bias = _rne.rne(m, d2, cvel, cdof_dot)
    _, qfrc_act, _ = _actuation.actuation(m, d2)
    return _rne.passive(m, d2) - qfrc_bias + qfrc_act


def _implicit_integrate(m: Model, d: Data) -> Data:
    """mj_implicit: qvel += h (M - h qDeriv)^-1 (qfrc_smooth +
    qfrc_constraint), qDeriv = d(velocity forces)/d qvel by
    torch.func.jacfwd (the envs are independent, so the Jacobian of the
    batch sum is each env's own), the inverse by six Newton-Schulz steps
    seeded with (M + h diag(B))^-1."""
    h = m.opt.timestep
    _actuation.activation_mask(m)       # static tables, outside the transform
    jac = torch.func.jacfwd(lambda v: _vel_forces(m, d, v).sum(0))(d.qvel)
    A = d.qM - h * jac.permute(1, 0, 2)               # (B, nv, nv)
    Ainv = refine_inv_general(A, d.qMhBinv, iters=6)
    qacc = torch.einsum("nij,nj->ni", Ainv, d.qfrc_smooth + d.qfrc_constraint)
    qvel = d.qvel + h * qacc
    act = d.act + h * d.act_dot if m.na else d.act
    return d.replace(qpos=_integrate_pos(m, d.qpos, qvel, h), qvel=qvel,
                     act=act)


_RK4_A = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def _rk4(m: Model, d: Data, fused_position: bool = True) -> Data:
    """Classic 4th-order Runge-Kutta (mj_RungeKutta): d arrives with the
    first stage's forward dynamics; each further stage runs a full forward
    pass at the tableau-shifted state.  The state derivative is (qvel,
    qacc, act_dot); no implicit damping."""
    h = m.opt.timestep
    qpos0, qvel0, act0 = d.qpos, d.qvel, d.act
    F = [(d.qvel, d.qacc, d.act_dot)]

    def comb(coeffs):
        terms = [(c, F[j]) for j, c in enumerate(coeffs) if c != 0.0]
        dqvel = sum(c * f[0] for c, f in terms)
        dqacc = sum(c * f[1] for c, f in terms)
        dact = sum(c * f[2] for c, f in terms) if m.na else d.act_dot
        return dqvel, dqacc, dact

    def shifted(coeffs):
        dqvel, dqacc, dact = comb(coeffs)
        return dict(qpos=_integrate_pos(m, qpos0, dqvel, h),
                    qvel=qvel0 + h * dqacc,
                    act=act0 + h * dact if m.na else act0)

    for i in range(3):
        d = forward(m, d.replace(**shifted(_RK4_A[i][:i + 1])),
                    fused_position=fused_position)
        F.append((d.qvel, d.qacc, d.act_dot))
    return d.replace(**shifted(_RK4_B))


def step(m: Model, d: Data, refine_inverse: bool = False,
         fused_position: bool = True) -> Data:
    """One physics step: forward dynamics + the model's integrator (Euler
    and implicitfast through ``integrate``, RK4, full implicit)."""
    d = forward(m, d, refine_inverse, fused_position)
    with part("integrate"):       # RK4's forward passes tag their own parts
        if m.opt.integrator == int(IntegratorType.IMPLICIT):
            return _implicit_integrate(m, d)
        if m.opt.integrator == int(IntegratorType.RK4):
            return _rk4(m, d, fused_position)
        return integrate(m, d)
