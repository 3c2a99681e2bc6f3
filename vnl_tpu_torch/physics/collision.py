"""Narrowphase collision: static candidate pairs -> padded contact points
(PyTorch counterpart of vnl_tpu/physics/collision.py), batched over envs.

Every candidate pair always emits its maximum number of contact points and
activity is carried by the distance sign, so shapes are static.  Ported
pairs: plane-sphere, plane-capsule, plane-ellipsoid (the rodent's paws,
limbs, head and trunk against the floor) and sphere-box.  The other pairs
of the JAX package raise NotImplementedError.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vnl_tpu_torch import math as vmath
from vnl_tpu_torch.physics.model import Data, GeomType, Model

_PORTED = {(GeomType.PLANE, GeomType.SPHERE), (GeomType.PLANE, GeomType.CAPSULE),
           (GeomType.PLANE, GeomType.ELLIPSOID),
           (GeomType.SPHERE, GeomType.BOX)}


def _plane_frame(xmat):
    """Contact frame rows from plane rotation: normal=z, tangents=x,y."""
    return torch.stack([xmat[..., :, 2], xmat[..., :, 0], xmat[..., :, 1]],
                       dim=-2)


def _make_frame(n):
    """Orthonormal frame (rows n, t1, t2) with the given normal."""
    ez = n.new_tensor([0.0, 0.0, 1.0]).expand_as(n)
    ex = n.new_tensor([1.0, 0.0, 0.0]).expand_as(n)
    a = torch.where(torch.abs(n[..., 2:3]) < 0.9, ez, ex)
    t1 = vmath.cross(a, n)
    t1 = t1 / torch.clamp(vmath.norm(t1, keepdim=True), min=1e-12)
    return torch.stack([n, t1, vmath.cross(n, t1)], dim=-2)


def _plane_sphere(ppos, pmat, c, r):
    n = pmat[..., :, 2]
    dist = torch.sum(n * (c - ppos), -1) - r
    pos = c - n * (r + 0.5 * dist)[..., None]
    return dist, pos


def _sphere_box(c, r, bp, bR, bs):
    """Sphere vs box; returns (dist, pos, n), n from sphere to box."""
    local = torch.einsum("...ji,...j->...i", bR, c - bp)
    clamped = torch.maximum(torch.minimum(local, bs), -bs)
    delta = local - clamped
    dn = vmath.norm(delta)
    outside = dn > 1e-9
    n_out = delta / torch.clamp(dn, min=1e-12)[..., None]
    dist_out = dn - r
    face_d = bs - torch.abs(local)
    k = torch.argmin(face_d, dim=-1)
    ek = torch.eye(3, dtype=c.dtype, device=c.device)[k]
    sign = torch.sign(torch.gather(local, -1, k[..., None]))[..., 0]
    n_in = -ek * sign[..., None]
    dist_in = -(torch.amin(face_d, dim=-1) + r)
    n_local = torch.where(outside[..., None], n_out, n_in)
    dist = torch.where(outside, dist_out, dist_in)
    n = -torch.einsum("...ij,...j->...i", bR, n_local)
    surf = bp + torch.einsum("...ij,...j->...i", bR, clamped)
    return dist, surf + 0.5 * dist[..., None] * n, n


def _groups(m: Model):
    gt = np.asarray(m.geom_type)
    t1, t2 = gt[m.pair_geom1], gt[m.pair_geom2]
    for a, b in set(zip(t1.tolist(), t2.tolist())):
        if (a, b) not in _PORTED:
            raise NotImplementedError(
                f"no narrowphase for geom types {GeomType(a).name}-"
                f"{GeomType(b).name} in vnl_tpu_torch yet")

    def group(a, b):
        return np.nonzero((t1 == a) & (t2 == b))[0].astype(np.int64)

    return group


def pair_expansion(m: Model) -> np.ndarray:
    """Static (ncon_max,) map contact point -> candidate pair, in the order
    collide() emits contact points."""
    group = _groups(m)
    cap = group(GeomType.PLANE, GeomType.CAPSULE)
    out = [group(GeomType.PLANE, GeomType.SPHERE), cap, cap,
           group(GeomType.PLANE, GeomType.ELLIPSOID),
           group(GeomType.SPHERE, GeomType.BOX)]
    return np.concatenate(out).astype(np.int32)


def collide(m: Model, d: Data) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, np.ndarray]:
    """All candidate contact points of the batch: (dist (B, ncon),
    pos (B, ncon, 3), frame (B, ncon, 3, 3), con_pair numpy (ncon,))."""
    B = d.qpos.shape[0]
    dtype = d.qpos.dtype
    if m.ncon_max == 0:
        z = d.qpos.new_zeros
        return z(B, 0), z(B, 0, 3), z(B, 0, 3, 3), np.zeros(0, np.int32)
    group = _groups(m)
    gx, gm, size = d.geom_xpos, d.geom_xmat, m.geom_size
    dists, poss, frames = [], [], []

    def geoms(idx):
        return (m.index(m.pair_geom1[idx]), m.index(m.pair_geom2[idx]))

    idx = group(GeomType.PLANE, GeomType.SPHERE)
    if len(idx):
        g1, g2 = geoms(idx)
        dist, pos = _plane_sphere(gx[:, g1], gm[:, g1], gx[:, g2],
                                  size[g2][:, 0])
        dists.append(dist); poss.append(pos)
        frames.append(_plane_frame(gm[:, g1]))

    idx = group(GeomType.PLANE, GeomType.CAPSULE)
    if len(idx):
        g1, g2 = geoms(idx)
        axis = gm[:, g2][..., :, 2]
        h = size[g2][:, 1:2]
        for sgn in (1.0, -1.0):
            dist, pos = _plane_sphere(gx[:, g1], gm[:, g1],
                                      gx[:, g2] + sgn * axis * h,
                                      size[g2][:, 0])
            dists.append(dist); poss.append(pos)
            frames.append(_plane_frame(gm[:, g1]))

    idx = group(GeomType.PLANE, GeomType.ELLIPSOID)
    if len(idx):
        g1, g2 = geoms(idx)
        n = gm[:, g1][..., :, 2]
        R = gm[:, g2]
        s = size[g2]
        sn = s * torch.einsum("...ji,...j->...i", R, n)
        denom = torch.clamp(vmath.norm(sn), min=1e-12)
        p = gx[:, g2] + torch.einsum("...ij,...j->...i", R,
                                     -(s * sn) / denom[..., None])
        dist = torch.sum(n * (p - gx[:, g1]), -1)
        dists.append(dist); poss.append(p - 0.5 * dist[..., None] * n)
        frames.append(_plane_frame(gm[:, g1]))

    idx = group(GeomType.SPHERE, GeomType.BOX)
    if len(idx):
        g1, g2 = geoms(idx)
        dist, pos, n = _sphere_box(gx[:, g1], size[g1][:, 0], gx[:, g2],
                                   gm[:, g2], size[g2])
        dists.append(dist); poss.append(pos)
        frames.append(_make_frame(n))

    dist = torch.cat(dists, 1).to(dtype)
    assert dist.shape == (B, m.ncon_max), (dist.shape, m.ncon_max)
    return (dist, torch.cat(poss, 1), torch.cat(frames, 1),
            pair_expansion(m))
