"""Batched egocentric camera: analytic ray-primitive depth images of a
whole batch of envs as tensor ops (PyTorch counterpart of
vnl_tpu/render/jit_camera.py).

A fixed ray grid is cast from a body of every env of a ``Data`` against
the model's primitive geoms (plane, sphere, capsule, box, ellipsoid) with
closed-form intersections; the depth is min-reduced over the geoms and
shaded by distance (a headlight).  The JAX package builds a per-env
function for ``jax.vmap``; here ``camera(d)`` takes the batched ``Data``
of the port and returns (B, H, W, 3) at once, in float32 as the JAX
camera computes.  The (envs, rays, geoms) temporaries are chunked over
the envs so that they stay under ``chunk_bytes``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vnl_tpu_torch.physics.model import Data, GeomType, Model

_BIG = 1e9
# float32 temporaries of the size (envs x rays x geoms) alive at once
_TEMPS = 12


def _ray_sphere(d, oc, r):
    """Rays d (B, P, 3), origin minus centres oc (B, G, 3), radii (G,) ->
    (B, P, G) t (_BIG on a miss)."""
    b = torch.einsum("bpi,bgi->bpg", d, oc)
    cterm = (oc * oc).sum(-1) - r * r
    disc = b * b - cterm[:, None]
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    return torch.where((disc >= 0.0) & (t > 1e-6), t, _BIG)


def _ray_plane(o, d, p0, n):
    """Rays vs planes through p0 (B, G, 3) with normals n (B, G, 3)."""
    denom = torch.einsum("bpi,bgi->bpg", d, n)
    num = torch.einsum("bgi,bgi->bg", n, p0 - o[:, None])
    ok = torch.abs(denom) > 1e-9
    t = num[:, None] / torch.where(ok, denom, 1.0)
    return torch.where(ok & (t > 1e-6), t, _BIG)


def _ray_capsule(o, d, pa, axis, half, r):
    """Rays vs capsules (segment pa +- half * axis, radius r).  The
    quadratic of the infinite cylinder in the axis-orthogonal complement,
    with dq = d - (d.axis) axis expanded into per-ray and per-geom dot
    products, so that no (envs, rays, geoms, 3) temporary is made."""
    oc = o[:, None] - pa                                   # (B, G, 3)
    d_ax = torch.einsum("bpi,bgi->bpg", d, axis)
    oc_ax = (oc * axis).sum(-1)                            # (B, G)
    ocq = oc - oc_ax[..., None] * axis                     # (B, G, 3)
    # |dq|^2 = |d|^2 - d_ax^2 (2 - |axis|^2); dq.ocq = d.ocq - d_ax axis.ocq
    dd = (d * d).sum(-1)[..., None]                        # (B, P, 1)
    aa = (axis * axis).sum(-1)[:, None]                    # (B, 1, G)
    a = dd - d_ax * d_ax * (2.0 - aa)
    b = (torch.einsum("bpi,bgi->bpg", d, ocq)
         - d_ax * (axis * ocq).sum(-1)[:, None])
    c = (ocq * ocq).sum(-1) - r * r
    disc = b * b - a * c[:, None]
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_cyl = (-b - sq) / torch.where(a > 1e-12, a, 1.0)
    s = oc_ax[:, None] + t_cyl * d_ax     # axial coordinate of the hit
    ok = (disc >= 0.0) & (a > 1e-12) & (t_cyl > 1e-6) & (torch.abs(s) <= half)
    t_cyl = torch.where(ok, t_cyl, _BIG)
    e1 = pa + half[:, None] * axis
    e2 = pa - half[:, None] * axis
    t_s1 = _ray_sphere(d, o[:, None] - e1, r)
    t_s2 = _ray_sphere(d, o[:, None] - e2, r)
    return torch.minimum(t_cyl, torch.minimum(t_s1, t_s2))


def _ray_box(o, d, c, R, s):
    """Rays vs oriented boxes (centre c, rotation R (B, G, 3, 3), half-size
    s (G, 3)) by the slab method in the box frame."""
    ol = torch.einsum("bgji,bgj->bgi", R, o[:, None] - c)   # (B, G, 3)
    dl = torch.einsum("bgji,bpj->bpgi", R, d)               # (B, P, G, 3)
    inv = 1.0 / torch.where(torch.abs(dl) > 1e-9, dl, 1e-9)
    t1 = (-s - ol[:, None]) * inv
    t2 = (s - ol[:, None]) * inv
    tmin = torch.minimum(t1, t2).max(-1).values
    tmax = torch.maximum(t1, t2).min(-1).values
    return torch.where((tmax >= tmin) & (tmax > 1e-6) & (tmin > 1e-6),
                       tmin, _BIG)


def _ray_ellipsoid(o, d, c, R, s):
    """Rays vs ellipsoids: the sphere test in the axis-scaled frame."""
    ol = torch.einsum("bgji,bgj->bgi", R, o[:, None] - c) / s
    dl = torch.einsum("bgji,bpj->bpgi", R, d) / s
    a = (dl * dl).sum(-1)
    b = torch.einsum("bpgi,bgi->bpg", dl, ol)
    cc = (ol * ol).sum(-1) - 1.0
    disc = b * b - a * cc[:, None]
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / torch.where(a > 1e-12, a, 1.0)
    return torch.where((disc >= 0.0) & (t > 1e-6), t, _BIG)


def make_egocentric_camera(m: Model, body_name: str = "skull",
                           width: int = 64, height: int = 64,
                           fovy: float = 90.0,
                           forward_offset: float = 0.02,
                           max_depth: float = 2.0,
                           chunk_bytes: int = 2 << 30
                           ) -> Callable[[Data], torch.Tensor]:
    """Builds camera(d: Data) -> (B, height, width, 3) float32 in [0, 1],
    on the device of ``d``.

    The camera sits just ahead of ``body_name`` looking along the body
    x-axis with the body z-axis up (render/software.py
    render_egocentric's conventions).  Every env of ``d`` is rendered."""
    bid = m.body_names.index(body_name)
    gt = np.asarray(m.geom_type)
    focal = 0.5 * height / np.tan(np.deg2rad(fovy) / 2)
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    dirs_cam = np.stack([np.ones_like(xx, np.float32),          # fwd (x)
                         -(xx - width / 2) / focal,             # left (y)
                         -(yy - height / 2) / focal], axis=-1)  # up  (z)
    dirs_cam = (dirs_cam /
                np.linalg.norm(dirs_cam, axis=-1, keepdims=True)
                ).reshape(-1, 3).astype(np.float32)
    groups = {k: np.nonzero(gt == int(k))[0] for k in
              (GeomType.PLANE, GeomType.SPHERE, GeomType.CAPSULE,
               GeomType.BOX, GeomType.ELLIPSOID)}
    ncast = max(sum(len(g) for g in groups.values()), 1)
    per_env = width * height * ncast * 4 * _TEMPS
    chunk = max(1, int(chunk_bytes // per_env))

    def cast(d: Data, sl) -> torch.Tensor:
        dev = d.xpos.device
        size = m.geom_size.to(dev)
        Rb = d.xmat[sl, bid]                 # columns: body axes in world
        eye = d.xpos[sl, bid] + forward_offset * Rb[..., 0]
        # world ray dirs: camera axes = body x (fwd), y (left), z (up)
        rays = torch.einsum("pj,bij->bpi",
                            torch.as_tensor(dirs_cam, device=dev), Rb)
        depth = torch.full(rays.shape[:2], _BIG, dtype=rays.dtype,
                           device=dev)

        def upd(tg):
            return torch.minimum(depth, tg.min(-1).values)

        gxp, gxm = d.geom_xpos[sl], d.geom_xmat[sl]
        g = groups[GeomType.PLANE]
        if len(g):
            depth = upd(_ray_plane(eye, rays, gxp[:, g], gxm[:, g, :, 2]))
        g = groups[GeomType.SPHERE]
        if len(g):
            depth = upd(_ray_sphere(rays, eye[:, None] - gxp[:, g],
                                    size[g, 0]))
        g = groups[GeomType.CAPSULE]
        if len(g):
            depth = upd(_ray_capsule(eye, rays, gxp[:, g], gxm[:, g, :, 2],
                                     size[g, 1], size[g, 0]))
        g = groups[GeomType.BOX]
        if len(g):
            depth = upd(_ray_box(eye, rays, gxp[:, g], gxm[:, g], size[g]))
        g = groups[GeomType.ELLIPSOID]
        if len(g):
            depth = upd(_ray_ellipsoid(eye, rays, gxp[:, g], gxm[:, g],
                                       size[g]))

        hit = depth < _BIG
        # headlight shading: brightness falls off with depth
        shade = torch.where(hit, 1.0 / (1.0 + depth / max_depth), 0.15)
        return shade[..., None].expand(-1, -1, 3).reshape(
            -1, height, width, 3).to(torch.float32)

    def camera(d: Data) -> torch.Tensor:
        B = d.xpos.shape[0]
        return torch.cat([cast(d, slice(s, s + chunk))
                          for s in range(0, B, chunk)])

    return camera
