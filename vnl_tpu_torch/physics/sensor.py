"""Sensor evaluation (PyTorch counterpart of vnl_tpu/physics/sensor.py),
batched over envs: gyro, velocimeter and accelerometer at a site, touch at
a site, and subtreelinvel of a body (the kinds the MJCF compiler records;
force and torque sensors are skipped there).  Evaluated after forward
dynamics, from the post-constraint qacc and the contact forces."""

from __future__ import annotations

import numpy as np
import torch

from vnl_tpu_torch import math as vmath
from vnl_tpu_torch.physics import collision as _collision
from vnl_tpu_torch.physics import rne as _rne
from vnl_tpu_torch.physics.model import Data, GeomType, Model, SensorType


def _site_frames(m: Model, d: Data):
    """World positions (B, nsite, 3) and rotations (B, nsite, 3, 3)."""
    q = d.xquat[:, m.index(m.site_bodyid)]
    pos = d.xpos[:, m.index(m.site_bodyid)] + vmath.quat_rotate(
        q, m.site_pos.expand(q.shape[:-1] + (3,)))
    mat = vmath.quat_to_mat(vmath.quat_mul(q, m.site_quat.expand(q.shape)))
    return pos, mat


def sensors(m: Model, d: Data) -> torch.Tensor:
    """Returns sensordata (B, nsensordata)."""
    B, dtype = d.qpos.shape[0], d.qpos.dtype
    out = d.qpos.new_zeros(B, m.nsensordata)
    if m.nsensordata == 0:
        return out
    site_xpos, site_xmat = _site_frames(m, d)
    origin = d.subtree_com[:, m.index(m.body_rootid)]   # per-tree com

    def point_vel(body, point):
        v = d.cvel[:, body]
        return v[..., 3:] + vmath.cross(v[..., :3], point - origin[:, body])

    # total acceleration: chain sums of cdof qacc + cdof_dot qvel, less
    # gravity (an accelerometer reads the proper acceleration)
    _, cdof_dot = _rne.com_vel(m, d)
    cacc = torch.einsum("bv,nvk->nbk", m.table("body_chain_dof_mask", dtype),
                        d.cdof * d.qacc[..., None]
                        + cdof_dot * d.qvel[..., None])
    cacc = cacc + m.const(np.concatenate(
        [np.zeros(3), -np.asarray(m.opt.gravity)]), dtype)

    def point_acc(body, point):
        r = point - origin[:, body]
        a, v = cacc[:, body], d.cvel[:, body]
        lin_vel = v[..., 3:] + vmath.cross(v[..., :3], r)
        return (a[..., 3:] + vmath.cross(a[..., :3], r)
                + vmath.cross(v[..., :3], lin_vel))

    def to_site(obj, vec):
        return torch.einsum("bji,bj->bi", site_xmat[:, obj], vec)

    for i in range(m.nsensor):
        st = SensorType(int(m.sensor_type[i]))
        adr, dim = int(m.sensor_adr[i]), int(m.sensor_dim[i])
        obj = int(m.sensor_objid[i])
        body = int(m.site_bodyid[obj]) if st != SensorType.SUBTREELINVEL \
            else obj
        if st == SensorType.GYRO:
            val = to_site(obj, d.cvel[:, body, :3])
        elif st == SensorType.VELOCIMETER:
            val = to_site(obj, point_vel(body, site_xpos[:, obj]))
        elif st == SensorType.ACCELEROMETER:
            val = to_site(obj, point_acc(body, site_xpos[:, obj]))
        elif st == SensorType.SUBTREELINVEL:
            # mass-weighted body-com velocities over the subtree
            vcom = d.cvel[..., 3:] + vmath.cross(d.cvel[..., :3],
                                                 d.xipos - origin)
            mom = torch.einsum("bc,nck->nbk",
                               m.table("body_subtree_mask", dtype),
                               m.body_mass[:, None] * vcom)
            val = mom[:, obj] / torch.clamp(m.body_subtreemass[obj],
                                            min=1e-12)
        elif st == SensorType.TOUCH:
            val = _touch(m, d, obj, body, site_xpos[:, obj],
                         site_xmat[:, obj])[:, None]
        else:
            continue
        out[:, adr:adr + dim] = val
    return out


def _touch(m: Model, d: Data, site: int, body: int, spos, smat):
    """Sum of the normal forces of the contacts that involve the site's
    body and whose ray from the contact point along -normal meets the site
    volume (MuJoCo's touch zone)."""
    B, dtype = d.qpos.shape[0], d.qpos.dtype
    if m.ncon_max == 0:
        return d.qpos.new_zeros(B)
    con_pair = _collision.pair_expansion(m)
    cb1 = np.asarray(m.geom_bodyid)[np.asarray(m.pair_geom1)[con_pair]]
    cb2 = np.asarray(m.geom_bodyid)[np.asarray(m.pair_geom2)[con_pair]]
    on_body = m.const((cb1 == body) | (cb2 == body), dtype)
    local = torch.einsum("bji,bcj->bci", smat, d.contact_pos - spos[:, None])
    dirs = torch.einsum("bji,bcj->bci", smat, -d.contact_frame[:, :, 0])
    size = m.site_size[site]
    t = int(m.site_type[site])
    eps = 1e-12
    if t == int(GeomType.BOX):
        inv = 1.0 / torch.where(torch.abs(dirs) > eps, dirs,
                                torch.full_like(dirs, eps))
        t1 = (-size - local) * inv
        t2 = (size - local) * inv
        tmin = torch.amax(torch.minimum(t1, t2), -1)
        tmax = torch.amin(torch.maximum(t1, t2), -1)
        par_miss = torch.any((torch.abs(dirs) <= eps)
                             & (torch.abs(local) > size), -1)
        hit = (tmax >= torch.clamp(tmin, min=0.0)) & ~par_miss
    elif t in (int(GeomType.SPHERE), int(GeomType.ELLIPSOID),
               int(GeomType.CAPSULE)):
        # sphere(ized) test: normalise by the radii, solve |o + t d|^2 = 1
        radii = torch.where(size > eps, size, size[0])
        o, dd = local / radii, dirs / radii
        a = torch.sum(dd * dd, -1)
        b = 2.0 * torch.sum(o * dd, -1)
        c = torch.sum(o * o, -1) - 1.0
        disc = b * b - 4.0 * a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        hit = (disc >= 0) & ((c <= 0) | ((-b + sq) >= 0))
    else:
        hit = torch.zeros_like(local[..., 0], dtype=torch.bool)
    normal_force = torch.clamp(d.contact_force.sum(-1), min=0.0)
    return torch.sum(normal_force * on_body * hit.to(dtype), -1)
