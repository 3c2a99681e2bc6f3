"""Compile-time constants evaluated at qpos0 (mj_setConst equivalent; a
copy of vnl_tpu/mjcf/const0.py).

Small independent NumPy pipeline (FK -> com-frame inertia -> CRB mass
matrix) used to derive dof/body inverse weights for MuJoCo's diagApprox
constraint regularizer.  Kept separate from the batched engine on purpose: it
doubles as a host-side cross-check of the device implementation in tests.

At qpos0 every joint sits at its reference value, so forward kinematics
reduces to composing fixed body offsets.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from vnl_tpu_torch.physics.model import JointType


def _qmul(u, v):
    uw, ux, uy, uz = u
    vw, vx, vy, vz = v
    return np.array([
        uw * vw - ux * vx - uy * vy - uz * vz,
        uw * vx + ux * vw + uy * vz - uz * vy,
        uw * vy - ux * vz + uy * vw + uz * vx,
        uw * vz + ux * vy - uy * vx + uz * vw])


def _qrot(q, v):
    qw, qv = q[0], q[1:]
    c1 = np.cross(qv, v)
    return v + 2.0 * (qw * c1 + np.cross(qv, c1))


def _qmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0.0]])


def compute_invweight0(md: Dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (dof_invweight0 (nv,), body_invweight0 (nbody,), qM0 (nv,nv)).

    md holds the compiled numpy arrays (body_parentid, body_pos, ...).
    """
    nbody, nv, njnt = md["nbody"], md["nv"], md["njnt"]
    parent = md["body_parentid"]

    # FK at qpos0 (joints at reference values => pure offset chain)
    xpos = np.zeros((nbody, 3))
    xquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    for b in range(1, nbody):
        p = parent[b]
        xquat[b] = _qmul(xquat[p], md["body_quat"][b])
        xpos[b] = xpos[p] + _qrot(xquat[p], md["body_pos"][b])
        # free joints: body frame = qpos0 directly (equals chain result since
        # qpos0 was compiled from body_pos/quat)
    xipos = xpos + np.stack([_qrot(xquat[b], md["body_ipos"][b])
                             for b in range(nbody)])

    # subtree com
    mass = md["body_mass"]
    sub_m = mass.copy()
    sub_s = mass[:, None] * xipos
    for b in range(nbody - 1, 0, -1):
        sub_m[parent[b]] += sub_m[b]
        sub_s[parent[b]] += sub_s[b]
    subtree_com = sub_s / np.maximum(sub_m, 1e-12)[:, None]
    rootid = md["body_rootid"]
    origin = subtree_com[rootid]

    # spatial inertias about per-tree origin
    cinert = np.zeros((nbody, 6, 6))
    for b in range(1, nbody):
        R = _qmat(_qmul(xquat[b], md["body_iquat"][b]))
        Ic = R @ np.diag(md["body_inertia"][b]) @ R.T
        c = xipos[b] - origin[b]
        cx = _skew(c)
        m_ = mass[b]
        cinert[b, :3, :3] = Ic + m_ * (cx @ cx.T)
        cinert[b, :3, 3:] = m_ * cx
        cinert[b, 3:, :3] = m_ * cx.T
        cinert[b, 3:, 3:] = m_ * np.eye(3)

    # cdof
    jnt_nv = {0: 6, 1: 3, 2: 1, 3: 1}
    cdof = np.zeros((nv, 6))
    xanchor = np.zeros((njnt, 3))
    for j in range(njnt):
        jt = int(md["jnt_type"][j])
        b = md["jnt_bodyid"][j]
        adr = md["jnt_dofadr"][j]
        anchor = xpos[b] + _qrot(xquat[b], md["jnt_pos"][j])
        xanchor[j] = anchor
        org = origin[b]
        if jt == int(JointType.FREE):
            for k in range(3):
                cdof[adr + k, 3 + k] = 1.0
            Rb = _qmat(xquat[b])
            for k in range(3):
                w = Rb[:, k]
                cdof[adr + 3 + k, :3] = w
                cdof[adr + 3 + k, 3:] = np.cross(w, org - anchor)
        elif jt == int(JointType.BALL):
            Rb = _qmat(xquat[b])
            for k in range(3):
                w = Rb[:, k]
                cdof[adr + k, :3] = w
                cdof[adr + k, 3:] = np.cross(w, org - anchor)
        else:
            ax = _qrot(xquat[b], md["jnt_axis"][j])
            if jt == int(JointType.HINGE):
                cdof[adr, :3] = ax
                cdof[adr, 3:] = np.cross(ax, org - anchor)
            else:
                cdof[adr, 3:] = ax

    # CRB mass matrix
    crb = cinert.copy()
    for b in range(nbody - 1, 0, -1):
        crb[parent[b]] += crb[b]
    F = np.einsum("vij,vj->vi", crb[md["dof_bodyid"]], cdof)
    M_full = F @ cdof.T
    maskl = md["dof_ancestor_mask"].astype(np.float64)
    Ml = M_full * maskl
    qM = Ml + Ml.T - np.diag(np.diag(Ml))
    qM += np.diag(md["dof_armature"])

    Minv = np.linalg.inv(qM) if nv else np.zeros((0, 0))
    dof_invweight0 = np.diag(Minv).copy()

    # body translational invweight: mean diag of J Minv J^T with J the
    # point jacobian at the body com
    bd_mask = np.zeros((nbody, nv))
    for b in range(1, nbody):
        bb = b
        while bb != 0:
            a0 = md["body_dofadr"][bb]
            bd_mask[b, a0:a0 + md["body_dofnum"][bb]] = 1.0
            bb = parent[bb]
    body_invweight0 = np.zeros(nbody)
    body_invweight0_rot = np.zeros(nbody)
    for b in range(1, nbody):
        rel = xipos[b] - origin[b]
        J = (cdof[:, 3:] + np.cross(cdof[:, :3], rel[None, :])) \
            * bd_mask[b][:, None]  # (nv, 3)
        A = J.T @ Minv @ J
        body_invweight0[b] = np.trace(A) / 3.0
        Jr = cdof[:, :3] * bd_mask[b][:, None]
        body_invweight0_rot[b] = np.trace(Jr.T @ Minv @ Jr) / 3.0

    # free/ball joint dofs use body-level inverse weights (mj_setConst);
    # free translation is evaluated at the body frame origin (xpos), while
    # body_invweight0 itself is at the body com (xipos) — verified against
    # the oracle on the humanoid, where the two differ.
    for j in range(njnt):
        jt = int(md["jnt_type"][j])
        b = md["jnt_bodyid"][j]
        adr = md["jnt_dofadr"][j]
        if jt == int(JointType.FREE):
            rel = xpos[b] - origin[b]
            J = (cdof[:, 3:] + np.cross(cdof[:, :3], rel[None, :])) \
                * bd_mask[b][:, None]
            iw_trans_origin = np.trace(J.T @ Minv @ J) / 3.0
            dof_invweight0[adr:adr + 3] = iw_trans_origin
            dof_invweight0[adr + 3:adr + 6] = body_invweight0_rot[b]
        elif jt == int(JointType.BALL):
            dof_invweight0[adr:adr + 3] = body_invweight0_rot[b]
    return dof_invweight0, body_invweight0, qM
