"""Actuation: gain/bias forces and activation dynamics (PyTorch
counterpart of vnl_tpu/physics/actuation.py), batched.  Joint
transmissions; fixed/affine gain, none/affine bias, none/integrator/filter
activation dynamics."""

from __future__ import annotations

import numpy as np
import torch

from vnl_tpu_torch.physics.model import (BiasType, Data, DisableBit, DynType,
                                         GainType, Model)


def actuation(m: Model, d: Data):
    """Returns (actuator_force (B, nu), qfrc_actuator (B, nv),
    act_dot (B, na))."""
    B = d.qpos.shape[0]
    if m.nu == 0 or (m.opt.disableflags & DisableBit.ACTUATION):
        z = d.qpos.new_zeros
        return z(B, m.nu), z(B, m.nv), z(B, m.na)
    ctrl = d.ctrl
    if not (m.opt.disableflags & DisableBit.CLAMPCTRL):
        lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
        ctrl = torch.where(m.actuator_ctrllimited,
                           torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)
    trn = np.asarray(m.actuator_trnid)
    dadr = m.index(m.jnt_dofadr[trn])
    gear = m.actuator_gear
    length = d.qpos[:, m.index(m.jnt_qposadr[trn])] * gear
    velocity = d.qvel[:, dadr] * gear

    if "has_act" not in m.cache:
        m.cache["has_act"] = m.actuator_actadr.cpu().numpy() >= 0
    has_act = m.cache["has_act"]
    if m.na:
        act_of_u = d.act[:, torch.clamp(m.actuator_actadr.long(), min=0)]
        dyn_filter = m.const(m.actuator_dyntype == int(DynType.FILTER),
                             torch.bool)
        tau = torch.clamp(m.actuator_dynprm[:, 0], min=1e-8)
        act_dot_u = torch.where(dyn_filter, (ctrl - act_of_u) / tau, ctrl)
        act_dot = act_dot_u[:, m.index(np.nonzero(has_act)[0])]
        inp = torch.where(m.const(has_act, torch.bool), act_of_u, ctrl)
    else:
        act_dot = d.qpos.new_zeros(B, 0)
        inp = ctrl

    gp, bp = m.actuator_gainprm, m.actuator_biasprm
    gain = torch.where(
        m.const(m.actuator_gaintype == int(GainType.AFFINE), torch.bool),
        gp[:, 0] + gp[:, 1] * length + gp[:, 2] * velocity,
        gp[:, 0].expand_as(length))
    bias = torch.where(
        m.const(m.actuator_biastype == int(BiasType.AFFINE), torch.bool),
        bp[:, 0] + bp[:, 1] * length + bp[:, 2] * velocity,
        torch.zeros_like(length))
    force = gain * inp + bias
    flo, fhi = m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1]
    force = torch.where(m.actuator_forcelimited,
                        torch.minimum(torch.maximum(force, flo), fhi), force)
    qfrc = d.qpos.new_zeros(B, m.nv).index_add(1, dadr, gear * force)
    return force, qfrc, act_dot
