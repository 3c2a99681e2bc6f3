"""Narrowphase collision: static candidate pairs -> padded contact points
(PyTorch counterpart of vnl_tpu/physics/collision.py), batched over envs.

Every candidate pair always emits its maximum number of contact points and
activity is carried by the distance sign, so shapes are static.  The ten
pair types of the JAX package are ported: plane against sphere, capsule,
ellipsoid, cylinder and box; sphere-sphere, sphere-capsule, capsule-capsule,
sphere-box and box-box.  Contact points come out grouped by pair type in
the JAX package's order (``_ORDER``), so ``pair_expansion`` and every
contact array line up with vnl_tpu's.  Three convex pair types follow
them, which the JAX package does not have: sphere, capsule and ellipsoid
against an ellipsoid (``_sphere_ellipsoid``, ``_capsule_ellipsoid``,
``_ellipsoid_ellipsoid``), one contact each.

Box-box is SAT over the 15 candidate axes with a fixed 8-point manifold:
25 candidates (the 8 + 8 corners against the opposing support plane, and 9
edge-edge closest points, each active only when the SAT minimum is its
axis), the 8 deepest kept.  "Deepest" is a stable sort (ties keep the lower
index first, as XLA's top_k does), so tied corners land in the same slots
as in the JAX package.

``collide`` is the plain narrowphase on any device: the CPU's path and
the yardstick of kernel E (ops/collision.py, csrc/collision.cu), which
forward runs in its place on a CUDA device, one launch for all pair
groups.
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
          (G.SPHERE, G.BOX, 1), (G.BOX, G.BOX, 8),
          (G.SPHERE, G.ELLIPSOID, 1), (G.CAPSULE, G.ELLIPSOID, 1),
          (G.ELLIPSOID, G.ELLIPSOID, 1))
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

# ---- the convex pairs: sphere, capsule or ellipsoid against an ellipsoid ----
# Each side is a core (a point, a segment or an ellipsoid) swept by a radius
# (0 for an ellipsoid).  With h the support functions of the cores, the
# signed distance of the cores is -min over unit u of H(u) = h2(u) + h1(-u)
# (the separating axis theorem; negative where they overlap, its minimiser
# the exact penetration axis that MuJoCo's EPA approaches), and the normal
# from geom 1 to geom 2 is -u.  An ellipsoid's part of H is |S R^T u| (S
# its semi-axes), smooth, so H is minimised by Newton steps on the sphere
# in a trust region, _CONVEX_ITERS of them: a fixed count and no
# data-dependent exit, as the solvers run.  Where the cores overlap H may
# have several local leasts on the sphere (a point deep in an ellipsoid
# has one on either side), so a search runs from every start direction
# (-d and both signs of every ellipsoid's axes) and the least end is kept,
# the first of ties: one search from the best start ends in the wrong
# least on some of those shapes, and which one it ends in turns on a tie
# that rounding decides.
# A segment's part is hl |u . a|, a kink where u is normal to its axis, so
# a capsule takes the least of three smooth problems: either end point,
# and u on the circle normal to the axis, each searched from each of its
# starts (_CIRCLE_STARTS angles on the circle), and every end held to the
# capsule's own H (a problem's least may lie where the other end's point
# decides H).  The contact point is the midpoint of the two witness points:
# the ellipsoid's support point moved back by half the distance along the
# normal, as _pp_ellipsoid places its point.

_CONVEX_ITERS = 12      # Newton steps on the sphere (and on the circle)
_CONVEX_RADIUS = 0.5    # first trust radius, rad
_CIRCLE_STARTS = 8      # start angles of the capsule's circle problem


def _ell_norm(M, u):
    """|M u| of an ellipsoid's M = S R^T with its gradient and Hessian in
    u: ((..), (.., 3), (.., 3, 3))."""
    Mu = torch.einsum("...ij,...j->...i", M, u)
    n = torch.clamp(vmath.norm(Mu), min=1e-12)
    g = torch.einsum("...ji,...j->...i", M, Mu) / n[..., None]
    MtM = torch.einsum("...ki,...kj->...ij", M, M)
    H = (MtM - g[..., :, None] * g[..., None, :]) / n[..., None, None]
    return n, g, H


def _support_h(d, Ms, u):
    """H(u) = u . d + sum |M u| over ``Ms``, with its gradient and Hessian
    in u."""
    val = torch.sum(u * d, -1)
    grad = d.expand(u.shape)
    hess = torch.zeros(u.shape + (3,), dtype=u.dtype, device=u.device)
    for M in Ms:
        n, g, H = _ell_norm(M, u)
        val, grad, hess = val + n, grad + g, hess + H
    return val, grad, hess


def _normalize(v):
    return v / torch.clamp(vmath.norm(v, keepdim=True), min=1e-12)


def _min_on_sphere(d, Ms, u):
    """Newton steps on the unit sphere from ``u`` for the least H: (u,
    H(u)).  The Riemannian Hessian of H on the sphere is T^T hess T - H
    (H is 1-homogeneous), shifted to be positive definite; a step that
    does not lower H is refused and the trust radius quartered."""
    val, grad, hess = _support_h(d, Ms, u)
    radius = torch.full_like(val, _CONVEX_RADIUS)
    for _ in range(_CONVEX_ITERS):
        T = _make_frame(u)[..., 1:, :]                    # (.., 2, 3)
        g = torch.einsum("...ki,...i->...k", T, grad)
        Hr = torch.einsum("...ki,...ij,...lj->...kl", T, hess, T)
        a = Hr[..., 0, 0] - val
        b = Hr[..., 0, 1]
        c = Hr[..., 1, 1] - val
        lmin = 0.5 * (a + c) - torch.sqrt(0.25 * (a - c) ** 2 + b * b)
        shift = torch.clamp(1e-6 - lmin, min=0.0)
        a, c = a + shift, c + shift
        det = torch.clamp(a * c - b * b, min=1e-30)
        e0 = -(c * g[..., 0] - b * g[..., 1]) / det
        e1 = -(a * g[..., 1] - b * g[..., 0]) / det
        step = torch.sqrt(e0 * e0 + e1 * e1)
        k = torch.clamp(radius / torch.clamp(step, min=1e-30), max=1.0)
        u_new = _normalize(u + (k * e0)[..., None] * T[..., 0, :]
                           + (k * e1)[..., None] * T[..., 1, :])
        v_new, g_new, h_new = _support_h(d, Ms, u_new)
        ok = v_new < val
        u = torch.where(ok[..., None], u_new, u)
        val = torch.where(ok, v_new, val)
        grad = torch.where(ok[..., None], g_new, grad)
        hess = torch.where(ok[..., None, None], h_new, hess)
        radius = torch.where(ok, torch.clamp(2.0 * radius, max=1.0),
                             0.25 * radius)
    return u, val


def _search_circle(d, M, e1, e2, t):
    """Newton steps on the circle u = cos t e1 + sin t e2 for the least of
    H(u) = u . d + |M u|, from the angles ``t`` (..): (u, H(u))."""
    u = torch.cos(t)[..., None] * e1 + torch.sin(t)[..., None] * e2
    val, grad, hess = _support_h(d, [M], u)
    radius = torch.full_like(val, _CONVEX_RADIUS)
    for _ in range(_CONVEX_ITERS):
        w = -torch.sin(t)[..., None] * e1 + torch.cos(t)[..., None] * e2
        f1 = torch.sum(grad * w, -1)
        f2 = torch.einsum("...i,...ij,...j->...", w, hess, w) - val
        newton = -f1 / torch.clamp(f2, min=1e-30)
        step = torch.where(f2 > 0.0, newton, -torch.sign(f1) * radius)
        t_new = t + torch.clamp(step, -radius, radius)
        u_new = (torch.cos(t_new)[..., None] * e1
                 + torch.sin(t_new)[..., None] * e2)
        v_new, g_new, h_new = _support_h(d, [M], u_new)
        ok = v_new < val
        t = torch.where(ok, t_new, t)
        u = torch.where(ok[..., None], u_new, u)
        val = torch.where(ok, v_new, val)
        grad = torch.where(ok[..., None], g_new, grad)
        hess = torch.where(ok[..., None, None], h_new, hess)
        radius = torch.where(ok, torch.clamp(2.0 * radius, max=1.0),
                             0.25 * radius)
    return u, val


def _circle_angles(d):
    return vmath.constant(tuple(
        2.0 * np.pi * k / _CIRCLE_STARTS for k in range(_CIRCLE_STARTS)), d)


def _every_circle_start(d, M, e1, e2):
    """_search_circle's ends from each of the _CIRCLE_STARTS angles:
    (.., _CIRCLE_STARTS, 3)."""
    angles = _circle_angles(d)
    t = angles.expand(d.shape[:-1] + angles.shape)
    return _search_circle(d[..., None, :], M[..., None, :, :],
                          e1[..., None, :], e2[..., None, :], t)[0]


def _every_start(d, Ms, starts):
    """_min_on_sphere's ends from each of ``starts`` (.., K, 3): (u, H),
    (.., K, 3) and (.., K)."""
    shape = starts.shape[:-1]
    return _min_on_sphere(d[..., None, :].expand(starts.shape),
                          [M[..., None, :, :].expand(shape + (3, 3))
                           for M in Ms], starts)


def _pick(u, val):
    """The candidate (.., K, 3) of least ``val`` (.., K), the first of
    ties: (u, val)."""
    k = torch.argmin(val, -1)
    return (torch.gather(u, -2, k[..., None, None].expand(
        k.shape + (1, 3)))[..., 0, :],
        torch.gather(val, -1, k[..., None])[..., 0])


def _least_on_sphere(d, Ms, starts):
    """The least H on the sphere, of the searches from each of ``starts``
    (in their order; the first of ties): (u, H(u))."""
    return _pick(*_every_start(d, Ms, starts))


def _ell_m(R, s):
    """M = S R^T of ellipsoids with rotations R (.., 3, 3), semi-axes s."""
    return s[..., :, None] * R.transpose(-1, -2)


def _axis_starts(d, Rs):
    """Start directions: -d (the direction between the centres; an axis
    of the first rotation where the centres meet) and both signs of every
    axis of the rotations ``Rs``: (.., 1 + 6 len(Rs), 3)."""
    dn = vmath.norm(d)
    toward = torch.where((dn > 1e-9)[..., None],
                         -d / torch.clamp(dn, min=1e-12)[..., None],
                         Rs[0][..., :, 0])
    axes = [toward]
    for R in Rs:
        for j in range(3):
            axes += [R[..., :, j], -R[..., :, j]]
    return torch.stack(axes, -2)


def _convex_contact(u, val, r1, x2, M2, R2, s2):
    """The contact from the least H: (dist, pos, frame).  The cores'
    signed distance is -val, the normal -u; the witness on the ellipsoid
    (geom 2) is its support point in u."""
    n = -u
    dist = -val - r1
    Mu = torch.einsum("...ij,...j->...i", M2, u)
    sup = x2 + torch.einsum("...ij,...j->...i", R2,
                            s2 * Mu) / torch.clamp(
        vmath.norm(Mu), min=1e-12)[..., None]
    return [(dist, sup - 0.5 * dist[..., None] * n, _make_frame(n))]


def _sphere_ellipsoid(x1, R1, s1, x2, R2, s2):
    M2 = _ell_m(R2, s2)
    d = x2 - x1
    u, val = _least_on_sphere(d, [M2], _axis_starts(d, [R2]))
    return _convex_contact(u, val, s1[:, 0], x2, M2, R2, s2)


def _capsule_ellipsoid(x1, R1, s1, x2, R2, s2):
    """The least of three problems: each end point against the ellipsoid
    from each of its starts, and u normal to the capsule's axis from each
    of its angles (in that order; the first of ties), every end held to
    the capsule's H."""
    M2 = _ell_m(R2, s2)
    a = R1[..., :, 2]
    hl = s1[:, 1:2]
    dc = x2 - x1
    F = _make_frame(a)
    ends = []
    for sgn in (1.0, -1.0):
        d = dc - sgn * hl * a
        ends.append(_every_start(d, [M2], _axis_starts(d, [R2]))[0])
    ends.append(_every_circle_start(dc, M2, F[..., 1, :], F[..., 2, :]))
    u = torch.cat(ends, -2)
    val = (_support_h(dc[..., None, :], [M2[..., None, :, :]], u)[0]
           + hl * torch.abs(torch.sum(u * a[..., None, :], -1)))
    u, val = _pick(u, val)
    return _convex_contact(u, val, s1[:, 0], x2, M2, R2, s2)


def _ellipsoid_ellipsoid(x1, R1, s1, x2, R2, s2):
    M1, M2 = _ell_m(R1, s1), _ell_m(R2, s2)
    d = x2 - x1
    u, val = _least_on_sphere(d, [M2, M1], _axis_starts(d, [R2, R1]))
    return _convex_contact(u, val, torch.zeros_like(s1[:, 0]), x2, M2, R2,
                           s2)


_NARROWPHASE = {
    (G.PLANE, G.SPHERE): _pp_sphere, (G.PLANE, G.CAPSULE): _pp_capsule,
    (G.PLANE, G.ELLIPSOID): _pp_ellipsoid,
    (G.PLANE, G.CYLINDER): _pp_cylinder, (G.PLANE, G.BOX): _pp_box,
    (G.SPHERE, G.SPHERE): _sphere_sphere,
    (G.SPHERE, G.CAPSULE): _sphere_capsule,
    (G.CAPSULE, G.CAPSULE): _capsule_capsule,
    (G.SPHERE, G.BOX): _sphere_box_pairs, (G.BOX, G.BOX): _box_box_pairs,
    (G.SPHERE, G.ELLIPSOID): _sphere_ellipsoid,
    (G.CAPSULE, G.ELLIPSOID): _capsule_ellipsoid,
    (G.ELLIPSOID, G.ELLIPSOID): _ellipsoid_ellipsoid}


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
    pos (B, ncon, 3), frame (B, ncon, 3, 3), con_pair numpy (ncon,))."""
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
