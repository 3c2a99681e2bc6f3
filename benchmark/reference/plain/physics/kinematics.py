"""Forward kinematics and com-frame quantities (PyTorch counterpart of
vnl_tpu/physics/kinematics.py), batched over envs.

World poses are composed in ordinary tree order: bodies are numbered so a
parent precedes its children, and each body composes its parent's pose with
its body offset and then with each of its joints.  (The JAX package's
pointer doubling over a node graph is a TPU device; on the card the whole
position stage is kernel A, ops/position.py.)
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.plain import math as vmath
from benchmark.reference.plain.physics.model import Data, JointType, Model


def kinematics(m: Model, d: Data) -> Data:
    """xpos/xquat/xmat/xipos, joint anchors/axes and geom poses."""
    qpos = d.qpos
    B = qpos.shape[0]
    dtype = qpos.dtype
    unit = vmath.constant((1.0, 0.0, 0.0, 0.0), qpos).expand(B, 4)
    xpos = [qpos.new_zeros(B, 3)]
    xquat = [unit]
    anchor = [None] * m.njnt
    axis = [None] * m.njnt
    jt = m.jnt_type
    for b in range(1, m.nbody):
        p = int(m.body_parentid[b])
        pos = xpos[p] + vmath.quat_rotate(xquat[p], m.body_pos[b])
        quat = vmath.quat_mul(xquat[p], m.body_quat[b].expand(B, 4))
        for j in range(int(m.body_jntadr[b]),
                       int(m.body_jntadr[b] + m.body_jntnum[b])):
            qa = int(m.jnt_qposadr[j])
            if jt[j] == JointType.FREE:      # resets the chain to world
                pos = qpos[:, qa:qa + 3]
                quat = vmath.normalize(qpos[:, qa + 3:qa + 7])
                axis[j] = m.jnt_axis[j].to(dtype).expand(B, 3)
                continue
            quat = vmath.normalize(quat)     # frame before the joint
            anchor[j] = pos + vmath.quat_rotate(quat, m.jnt_pos[j])
            axis[j] = vmath.quat_rotate(quat, m.jnt_axis[j])
            scalar = qpos[:, qa] - m.qpos0[qa]
            if jt[j] == JointType.SLIDE:
                q_loc = unit
                p_loc = m.jnt_axis[j] * scalar[:, None]
            else:
                if jt[j] == JointType.HINGE:
                    q_loc = vmath.axis_angle_to_quat(m.jnt_axis[j], scalar)
                else:                        # BALL
                    q_loc = vmath.normalize(qpos[:, qa:qa + 4])
                p_loc = m.jnt_pos[j] - vmath.quat_rotate(q_loc, m.jnt_pos[j])
            pos = pos + vmath.quat_rotate(quat, p_loc)
            quat = vmath.quat_mul(quat, q_loc)
        xpos.append(pos)
        xquat.append(vmath.normalize(quat))
    xpos = torch.stack(xpos, 1)
    xquat = torch.stack(xquat, 1)
    for j in np.nonzero(jt == JointType.FREE)[0]:
        anchor[j] = xpos[:, int(m.jnt_bodyid[j])]
    xanchor = torch.stack(anchor, 1)
    xaxis = torch.stack(axis, 1)

    xmat = vmath.quat_to_mat(xquat)
    xipos = xpos + vmath.quat_rotate(xquat, m.body_ipos)
    gb = m.index(m.geom_bodyid)
    geom_xpos = xpos[:, gb] + vmath.quat_rotate(xquat[:, gb], m.geom_pos)
    geom_xmat = vmath.quat_to_mat(vmath.quat_mul(
        xquat[:, gb], m.geom_quat.expand(B, -1, 4)))
    return d.replace(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
                     xanchor=xanchor, xaxis=xaxis, geom_xpos=geom_xpos,
                     geom_xmat=geom_xmat)


def dof_tables(m: Model):
    """Static per-dof tables: (is_free_translation, is_local_rotation,
    is_hinge, is_slide, axis_idx), all numpy (nv,)."""
    njnt_nv = {int(JointType.FREE): 6, int(JointType.BALL): 3,
               int(JointType.SLIDE): 1, int(JointType.HINGE): 1}
    dof_sub = np.zeros(m.nv, dtype=np.int64)
    for j in range(m.njnt):
        n = njnt_nv[int(m.jnt_type[j])]
        dof_sub[m.jnt_dofadr[j]:m.jnt_dofadr[j] + n] = np.arange(n)
    jt = m.jnt_type[m.dof_jntid]
    free = jt == int(JointType.FREE)
    is_free_t = free & (dof_sub < 3)
    is_local_rot = (jt == int(JointType.BALL)) | (free & (dof_sub >= 3))
    axis_idx = np.where(free & (dof_sub >= 3), dof_sub - 3,
                        dof_sub).clip(0, 2)
    return (is_free_t, is_local_rot, jt == int(JointType.HINGE),
            jt == int(JointType.SLIDE), axis_idx)


def com_pos(m: Model, d: Data) -> Data:
    """Subtree com, com-frame spatial inertias (cinert) and dof axes (cdof),
    all about the subtree com of each body's kinematic root (mj_comPos)."""
    dtype = d.qpos.dtype
    mass = m.body_mass
    sub_mask = m.table("body_subtree_mask", dtype)
    sub_sum = torch.einsum("bc,nci->nbi", sub_mask, mass[:, None] * d.xipos)
    sub_m = sub_mask @ mass
    subtree_com = sub_sum / torch.clamp(sub_m, min=1e-12)[:, None]
    origin = subtree_com[:, m.index(m.body_rootid)]

    irot = vmath.quat_to_mat(vmath.quat_mul(d.xquat, m.body_iquat))
    cinert = vmath.inertia_at_point(mass, m.body_inertia, irot, d.xipos,
                                    origin)

    is_free_t, is_local_rot, is_hinge, is_slide, axis_idx = dof_tables(m)
    db = m.index(m.dof_bodyid)
    dj = m.index(m.dof_jntid)
    org_d = origin[:, db]
    anchor_d = d.xanchor[:, dj]
    hinge_axes = d.xaxis[:, dj]
    xm = d.xmat[:, db]                               # (B, nv, 3, 3)
    ax = m.index(axis_idx).view(1, m.nv, 1, 1).expand(xm.shape[0], m.nv, 3, 1)
    local_axes = torch.gather(xm, 3, ax)[..., 0]     # column axis_idx
    eye_rows = torch.eye(3, dtype=dtype, device=db.device)[m.index(axis_idx)]

    def col(mask):
        return m.index(mask).bool()[None, :, None]

    w = torch.where(col(is_hinge), hinge_axes,
                    torch.where(col(is_local_rot), local_axes,
                                torch.zeros_like(hinge_axes)))
    lin_rot = vmath.cross(w, org_d - anchor_d)
    lin = torch.where(col(is_free_t), eye_rows.expand_as(w),
                      torch.where(col(is_slide), hinge_axes, lin_rot))
    cdof = torch.cat([w, lin], -1)
    return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)
