"""The convex pairs of the CMU humanoid's narrowphase: sphere, capsule and
ellipsoid against an ellipsoid, one contact each, batched over envs, as the
port's ``vnl_tpu_torch/physics/collision.py`` had them when the
configuration ``cmu_humanoid_tracking`` joined the benchmark.  Plain
PyTorch in the dtype of its inputs (float32 or float64); it imports nothing
of the port, of JAX or of vnl_tpu.

``register()`` appends the three pair types to the reference's
``collision._ORDER`` and ``_NARROWPHASE``, after its ten, so that no other
model's slots move; ``envs/cmu_humanoid.py`` calls it when it is imported,
and no other env of the reference imports this module.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.plain import math as vmath
from benchmark.reference.plain.physics import collision
from benchmark.reference.plain.physics.collision import _make_frame
from benchmark.reference.plain.physics.model import GeomType as G

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


PAIRS = ((G.SPHERE, G.ELLIPSOID, 1, _sphere_ellipsoid),
         (G.CAPSULE, G.ELLIPSOID, 1, _capsule_ellipsoid),
         (G.ELLIPSOID, G.ELLIPSOID, 1, _ellipsoid_ellipsoid))


def register() -> None:
    """Appends the three pair types to the reference's narrowphase (once)."""
    known = {(a, b) for a, b, _ in collision._ORDER}
    for a, b, k, fn in PAIRS:
        if (a, b) not in known:
            collision._ORDER = collision._ORDER + ((a, b, k),)
            collision._NARROWPHASE[(a, b)] = fn
