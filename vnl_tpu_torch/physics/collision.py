"""Narrowphase collision: static candidate pairs -> padded contact points
(PyTorch counterpart of vnl_tpu/physics/collision.py), batched over envs.

Every candidate pair always emits its maximum number of contact points and
activity is carried by the distance sign, so shapes are static.  All ten
pair types of the MJCF compiler are ported: plane against sphere, capsule,
ellipsoid, cylinder and box; sphere-sphere, sphere-capsule, capsule-capsule,
sphere-box and box-box.  Contact points come out grouped by pair type in
the JAX package's order (``_ORDER``), so ``pair_expansion`` and every
contact array line up with vnl_tpu's.

Box-box is SAT over the 15 candidate axes with a fixed 8-point manifold:
25 candidates (the 8 + 8 corners against the opposing support plane, and 9
edge-edge closest points, each active only when the SAT minimum is its
axis), the 8 deepest kept.  "Deepest" is a stable sort (ties keep the lower
index first, as XLA's top_k does), so tied corners land in the same slots
as in the JAX package.

On a CUDA device ``collide`` launches kernel E (ops/collision.py,
csrc/collision.cu), one launch for all pair groups; ``collide_plain`` is
the plain version, the CPU's path and the kernel's yardstick.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from vnl_tpu_torch import math as vmath
from vnl_tpu_torch.physics.model import Data, GeomType, Model

G = GeomType
# (type 1, type 2, contact points per pair), in the order collide() emits
_ORDER = ((G.PLANE, G.SPHERE, 1), (G.PLANE, G.CAPSULE, 2),
          (G.PLANE, G.ELLIPSOID, 1), (G.PLANE, G.CYLINDER, 4),
          (G.PLANE, G.BOX, 4), (G.SPHERE, G.SPHERE, 1),
          (G.SPHERE, G.CAPSULE, 1), (G.CAPSULE, G.CAPSULE, 1),
          (G.SPHERE, G.BOX, 1), (G.BOX, G.BOX, 8))
_CORNER_SIGNS = tuple((sx, sy, sz) for sx in (-1.0, 1.0)
                      for sy in (-1.0, 1.0) for sz in (-1.0, 1.0))


def _plane_frame(xmat):
    """Contact frame rows from plane rotation: normal=z, tangents=x,y."""
    return torch.stack([xmat[..., :, 2], xmat[..., :, 0], xmat[..., :, 1]],
                       dim=-2)


def _make_frame(n):
    """Orthonormal frame (rows n, t1, t2) with the given normal."""
    ez = vmath.constant((0.0, 0.0, 1.0), n).expand_as(n)
    ex = vmath.constant((1.0, 0.0, 0.0), n).expand_as(n)
    a = torch.where(torch.abs(n[..., 2:3]) < 0.9, ez, ex)
    t1 = vmath.cross(a, n)
    t1 = t1 / torch.clamp(vmath.norm(t1, keepdim=True), min=1e-12)
    return torch.stack([n, t1, vmath.cross(n, t1)], dim=-2)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _deepest(dist, k: int):
    """Indices of the k smallest distances along the last axis, ties in
    index order (jax.lax.top_k of -dist)."""
    return torch.sort(dist, dim=-1, stable=True).indices[..., :k]


def _plane_sphere(ppos, pmat, c, r):
    n = pmat[..., :, 2]
    dist = torch.sum(n * (c - ppos), -1) - r
    pos = c - n * (r + 0.5 * dist)[..., None]
    return dist, pos


def _sphere_box(c, r, bp, bR, bs):
    """Sphere vs box; returns (dist, pos, n), n from sphere to box."""
    local = torch.einsum("...ji,...j->...i", bR, c - bp)
    clamped = _clip(local, -bs, bs)
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


def _seg_closest(p0, d0, h0, p1, d1, h1):
    """Closest points of the segments p0 +- h0 d0 and p1 +- h1 d1."""
    r = p1 - p0
    a = torch.sum(d0 * d0, -1)
    e = torch.sum(d1 * d1, -1)
    f = torch.sum(d1 * r, -1)
    c = torch.sum(d0 * r, -1)
    b = torch.sum(d0 * d1, -1)
    den = torch.clamp(a * e - b * b, min=1e-12)
    s = _clip((b * f - c * e) / -den, -h0, h0)
    u = _clip((b * s + f) / torch.clamp(e, min=1e-12), -h1, h1)
    s = _clip((b * u + c) / torch.clamp(a, min=1e-12), -h0, h0)
    return p0 + s[..., None] * d0, p1 + u[..., None] * d1


def _box_box_candidates(pa, Ra, sa, pb, Rb, sb):
    """SAT box-box's 25 candidates: (dist (.., 25), pos (.., 25, 3),
    n (.., 3))."""
    dtype, dev = pa.dtype, pa.device
    R = torch.einsum("...ji,...jk->...ik", Ra, Rb)     # B axes in A frame
    t = torch.einsum("...ji,...j->...i", Ra, pb - pa)
    eye = torch.eye(3, dtype=dtype, device=dev).expand(R.shape)
    axes = [eye[..., :, i] for i in range(3)]
    axes += [R[..., :, j] for j in range(3)]
    axes += [vmath.cross(eye[..., :, i], R[..., :, j])
             for i in range(3) for j in range(3)]
    axes = torch.stack(axes, -2)                       # (.., 15, 3)
    anorm = torch.clamp(vmath.norm(axes), min=1e-12)
    axes = axes / anorm[..., None]

    ra = torch.einsum("...ki,...i->...k", torch.abs(axes), sa)
    proj = torch.einsum("...ki,...ij->...kj", axes, R)
    rb = torch.einsum("...kj,...j->...k", torch.abs(proj), sb)
    tl = torch.einsum("...ki,...i->...k", axes, t)
    depth = ra + rb - torch.abs(tl)
    # degenerate cross axes (parallel edges) are disabled
    valid = torch.cat([torch.ones_like(anorm[..., :6], dtype=torch.bool),
                       anorm[..., 6:] > 1e-6], -1)
    depth = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    kmin = torch.argmin(depth, dim=-1)
    l_min = torch.gather(axes, -2, kmin[..., None, None].expand(
        kmin.shape + (1, 3)))[..., 0, :]
    sgn = torch.sign(torch.gather(tl, -1, kmin[..., None]))[..., 0]
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    nA = l_min * sgn[..., None]                        # A frame, A -> B
    n = torch.einsum("...ij,...j->...i", Ra, nA)
    ra_n = torch.sum(torch.abs(nA) * sa, -1)
    nB = torch.einsum("...ji,...j->...i", R, nA)       # n in the B frame
    rb_n = torch.sum(torch.abs(nB) * sb, -1)

    signs = vmath.constant(_CORNER_SIGNS, pa)
    cb = pb[..., None, :] + torch.einsum("...ij,cj,...j->...ci", Rb, signs,
                                         sb)
    dist_b = (torch.einsum("...i,...ci->...c", n, cb - pa[..., None, :])
              - ra_n[..., None])
    pos_b = cb - 0.5 * dist_b[..., None] * n[..., None, :]
    ca = pa[..., None, :] + torch.einsum("...ij,cj,...j->...ci", Ra, signs,
                                         sa)
    dist_a = (-torch.einsum("...i,...ci->...c", n, ca - pb[..., None, :])
              - rb_n[..., None])
    pos_a = ca + 0.5 * dist_a[..., None] * n[..., None, :]

    ar3 = torch.arange(3, device=dev)
    min_depth = depth.amin(-1)
    e_dists, e_poss = [], []
    for i in range(3):
        for j in range(3):
            k = 6 + 3 * i + j
            lk = axes[..., k, :] * sgn[..., None]
            off_a = torch.where(ar3 == i, torch.zeros_like(sa),
                                sa * torch.sign(lk + 1e-12))
            off_b = torch.where(ar3 == j, torch.zeros_like(sb),
                                sb * -torch.sign(nB + 1e-12))
            q0, q1 = _seg_closest(
                pa + torch.einsum("...ij,...j->...i", Ra, off_a),
                Ra[..., :, i], sa[..., i],
                pb + torch.einsum("...ij,...j->...i", Rb, off_b),
                Rb[..., :, j], sb[..., j])
            e_dists.append(torch.where(kmin == k, -min_depth,
                                       torch.full_like(sgn, 1e3)))
            e_poss.append(0.5 * (q0 + q1))
    dist_all = torch.cat([dist_b, dist_a, torch.stack(e_dists, -1)], -1)
    pos_all = torch.cat([pos_b, pos_a, torch.stack(e_poss, -2)], -2)
    return dist_all, pos_all, n


def _box_box(pa, Ra, sa, pb, Rb, sb):
    """SAT box-box: returns (dist (.., 8), pos (.., 8, 3), n (.., 3)), the
    8 deepest candidates."""
    dist_all, pos_all, n = _box_box_candidates(pa, Ra, sa, pb, Rb, sb)
    top = _deepest(dist_all, 8)
    dist8 = torch.gather(dist_all, -1, top)
    pos8 = torch.gather(pos_all, -2, top[..., None].expand(top.shape + (3,)))
    return dist8, pos8, n


def _segpoint(p, a0, a1):
    """Closest point to p on the segment [a0, a1]."""
    ab = a1 - a0
    t = torch.sum((p - a0) * ab, -1) / torch.clamp(torch.sum(ab * ab, -1),
                                                   min=1e-12)
    return a0 + torch.clamp(t, 0.0, 1.0)[..., None] * ab


def _spheres(c1, r1, c2, r2):
    """Contact of spheres (c1, r1) and (c2, r2): one point, normal 1 -> 2."""
    delta = c2 - c1
    dnorm = torch.clamp(vmath.norm(delta), min=1e-12)
    n = delta / dnorm[..., None]
    dist = dnorm - (r1 + r2)
    return [(dist, c1 + n * (r1 + 0.5 * dist)[..., None], _make_frame(n))]


# ---- one function per pair type: (geom arrays of both sides) -> blocks ----
# Each takes (x1, R1, s1, x2, R2, s2): positions (B, G, 3), rotations
# (B, G, 3, 3) and sizes (G, 3) of the pairs' two geoms, and returns its
# contact points as a list of (dist (B, G), pos (B, G, 3), frame) blocks.

def _pp_sphere(x1, R1, s1, x2, R2, s2):
    dist, pos = _plane_sphere(x1, R1, x2, s2[:, 0])
    return [(dist, pos, _plane_frame(R1))]


def _pp_capsule(x1, R1, s1, x2, R2, s2):
    """Two points, at the endpoint spheres."""
    axis = R2[..., :, 2]
    out = []
    for sgn in (1.0, -1.0):
        dist, pos = _plane_sphere(x1, R1, x2 + sgn * axis * s2[:, 1:2],
                                  s2[:, 0])
        out.append((dist, pos, _plane_frame(R1)))
    return out


def _pp_ellipsoid(x1, R1, s1, x2, R2, s2):
    """One support point."""
    n = R1[..., :, 2]
    sn = s2 * torch.einsum("...ji,...j->...i", R2, n)
    denom = torch.clamp(vmath.norm(sn), min=1e-12)
    p = x2 + torch.einsum("...ij,...j->...i", R2,
                          -(s2 * sn) / denom[..., None])
    dist = torch.sum(n * (p - x1), -1)
    return [(dist, p - 0.5 * dist[..., None] * n, _plane_frame(R1))]


def _pp_cylinder(x1, R1, s1, x2, R2, s2):
    """Four rim points: both caps' rims along the steepest in-disk descent
    direction, and the lower cap's rim at that direction turned +-120 deg
    (a tripod when standing on a cap; above the plane otherwise)."""
    n = R1[..., :, 2]
    axis = R2[..., :, 2]
    r, h = s2[:, 0], s2[:, 1]
    cosa = torch.sum(n * axis, -1)
    u_raw = cosa[..., None] * axis - n
    sina = vmath.norm(u_raw)
    u = torch.where(sina[..., None] > 1e-6,
                    u_raw / torch.clamp(sina, min=1e-12)[..., None],
                    R2[..., :, 0])
    v = vmath.cross(axis, u)
    u120 = -0.5 * u + 0.8660254 * v
    u240 = -0.5 * u - 0.8660254 * v
    ones = torch.ones_like(u)
    s_low = -torch.sign(cosa + 1e-12)[..., None] * ones

    def rim(cap_sign, dirv):
        p = x2 + cap_sign * h[..., None] * axis + r[..., None] * dirv
        dist = torch.sum(n * (p - x1), -1)
        return dist, p - 0.5 * dist[..., None] * n, _plane_frame(R1)

    return [rim(cap, dirv) for cap, dirv in
            ((ones, u), (-ones, u), (s_low, u120), (s_low, u240))]


def _pp_box_candidates(x1, R1, s1, x2, R2, s2):
    """The eight corners against the plane: (dist (B, G, 8),
    pos (B, G, 8, 3))."""
    n = R1[..., :, 2]
    corners = vmath.constant(_CORNER_SIGNS, x1)
    pw = x2[..., None, :] + torch.einsum("bgij,cj,gj->bgci", R2, corners, s2)
    cdist = torch.einsum("bgi,bgci->bgc", n, pw - x1[..., None, :])
    return cdist, pw - 0.5 * cdist[..., None] * n[..., None, :]


def _pp_box(x1, R1, s1, x2, R2, s2):
    """The four deepest corners."""
    cdist, cpos = _pp_box_candidates(x1, R1, s1, x2, R2, s2)
    top = _deepest(cdist, 4)
    tdist = torch.gather(cdist, -1, top)
    tpos = torch.gather(cpos, -2, top[..., None].expand(top.shape + (3,)))
    return [(tdist[..., k], tpos[..., k, :], _plane_frame(R1))
            for k in range(4)]


def _sphere_sphere(x1, R1, s1, x2, R2, s2):
    return _spheres(x1, s1[:, 0], x2, s2[:, 0])


def _sphere_capsule(x1, R1, s1, x2, R2, s2):
    ax = R2[..., :, 2] * s2[:, 1:2]
    return _spheres(x1, s1[:, 0], _segpoint(x1, x2 - ax, x2 + ax), s2[:, 0])


def _capsule_capsule(x1, R1, s1, x2, R2, s2):
    """Closest points of the two segments by three alternations."""
    a_ax = R1[..., :, 2] * s1[:, 1:2]
    b_ax = R2[..., :, 2] * s2[:, 1:2]
    pa = x1
    for _ in range(3):
        pb = _segpoint(pa, x2 - b_ax, x2 + b_ax)
        pa = _segpoint(pb, x1 - a_ax, x1 + a_ax)
    return _spheres(pa, s1[:, 0], pb, s2[:, 0])


def _sphere_box_pairs(x1, R1, s1, x2, R2, s2):
    dist, pos, n = _sphere_box(x1, s1[:, 0], x2, R2, s2)
    return [(dist, pos, _make_frame(n))]


def _box_box_pairs(x1, R1, s1, x2, R2, s2):
    dist8, pos8, n = _box_box(x1, R1, s1, x2, R2, s2)
    frame = _make_frame(n)
    return [(dist8[..., k], pos8[..., k, :], frame) for k in range(8)]


_NARROWPHASE = {
    (G.PLANE, G.SPHERE): _pp_sphere, (G.PLANE, G.CAPSULE): _pp_capsule,
    (G.PLANE, G.ELLIPSOID): _pp_ellipsoid,
    (G.PLANE, G.CYLINDER): _pp_cylinder, (G.PLANE, G.BOX): _pp_box,
    (G.SPHERE, G.SPHERE): _sphere_sphere,
    (G.SPHERE, G.CAPSULE): _sphere_capsule,
    (G.CAPSULE, G.CAPSULE): _capsule_capsule,
    (G.SPHERE, G.BOX): _sphere_box_pairs, (G.BOX, G.BOX): _box_box_pairs}


def _groups(m: Model) -> List[Tuple[GeomType, GeomType, int, np.ndarray]]:
    """(type 1, type 2, points per pair, candidate pair indices) of each
    pair type the model has, in emission order."""
    gt = np.asarray(m.geom_type)
    t1, t2 = gt[m.pair_geom1], gt[m.pair_geom2]
    known = {(a, b) for a, b, _ in _ORDER}
    for a, b in set(zip(t1.tolist(), t2.tolist())):
        if (a, b) not in known:
            raise NotImplementedError(
                f"no narrowphase for geom types {GeomType(a).name}-"
                f"{GeomType(b).name}")
    out = []
    for a, b, k in _ORDER:
        idx = np.nonzero((t1 == a) & (t2 == b))[0].astype(np.int64)
        if len(idx):
            out.append((a, b, k, idx))
    return out


def pair_expansion(m: Model) -> np.ndarray:
    """Static (ncon_max,) map contact point -> candidate pair, in the order
    collide() emits contact points."""
    out = [idx for _, _, k, idx in _groups(m) for _ in range(k)]
    return (np.concatenate(out).astype(np.int32) if out
            else np.zeros(0, np.int32))


def collide(m: Model, d: Data) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, np.ndarray]:
    """All candidate contact points of the batch: (dist (B, ncon),
    pos (B, ncon, 3), frame (B, ncon, 3, 3), con_pair numpy (ncon,)).
    Kernel E (ops/collision.py) on CUDA tensors, which it takes in float32
    alone; the plain version on CPU tensors."""
    if not m.ncon_max or d.geom_xpos.device.type == "cpu":
        return collide_plain(m, d)
    if not d.geom_xpos.is_cuda:
        raise ValueError(f"no narrowphase for device {d.geom_xpos.device}")
    from vnl_tpu_torch.ops import collision as collision_ops
    return collision_ops.collide(m, d.geom_xpos.contiguous(),
                                 d.geom_xmat.contiguous())


def collide_plain(m: Model, d: Data) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor, np.ndarray]:
    """``collide`` in plain PyTorch, on any device."""
    B = d.qpos.shape[0]
    dtype = d.qpos.dtype
    if m.ncon_max == 0:
        z = d.qpos.new_zeros
        return z(B, 0), z(B, 0, 3), z(B, 0, 3, 3), np.zeros(0, np.int32)
    gx, gm, size = d.geom_xpos, d.geom_xmat, m.geom_size
    blocks = []
    for a, b, _, idx in _groups(m):
        g1, g2 = m.index(m.pair_geom1[idx]), m.index(m.pair_geom2[idx])
        blocks += _NARROWPHASE[(a, b)](gx[:, g1], gm[:, g1], size[g1],
                                       gx[:, g2], gm[:, g2], size[g2])
    dist = torch.cat([blk[0] for blk in blocks], 1).to(dtype)
    assert dist.shape == (B, m.ncon_max), (dist.shape, m.ncon_max)
    return (dist, torch.cat([blk[1] for blk in blocks], 1),
            torch.cat([blk[2] for blk in blocks], 1), pair_expansion(m))
