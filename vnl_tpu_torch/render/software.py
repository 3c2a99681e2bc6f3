"""Software ray-caster for eval videos, as batched tensor ops on the
renderer's device (PyTorch counterpart of vnl_tpu/render/software.py).

Per-pixel ray casting with a z-buffer over the compiled Model's geoms:
spheres, capsules, cylinders, boxes and ellipsoids intersect analytically
in their local frames, the ground plane renders as a checkerboard, and
translucent overlay instances blend against the opaque depth buffer.  The
conventions (camera, colours, shading, ground, blending) are the JAX
package's; its renderer is host numpy that loops over geoms and skin
faces.  Here a chunk of frames is cast at once, by type group, as flat
tensors of entries: one entry for each (frame, geom, pixel of the geom's
culling window), the pixels inside its projected bounding circle plus 2
px, where the JAX renderer tests the geom.  A ``scatter_reduce`` amin
takes each pixel's nearest hit, so the window masks the cast exactly as
it does in the JAX loop, and frames agree wherever a window cuts a
silhouette; the work is the windows' area, not pixels x geoms.  The skin
rasteriser works the same way on (face, pixel of its box) entries.  A
chunk's temporaries stay under about 2 GB (``chunk_bytes``).
Everything runs in float64, as the JAX renderer does; frames come back to
the host as uint8 only for encoding.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vnl_tpu_torch.physics.model import GeomType, JointType, Model
from vnl_tpu_torch.render.skin import quat_to_mat

_LIGHT = np.array([-0.35, 0.4, 0.85])
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)
_TMIN = 1e-4
_INF = float("inf")
_F64 = torch.float64
# the temporaries of one chunk of frames stay under this
CHUNK_BYTES = 2 << 30
# bytes of temporaries per entry (a geom at a pixel of its window, a skin
# face at a pixel of its box: about 40 float64 values) and per pixel
_ENTRY_BYTES = 320
_PIXEL_BYTES = 256
_DEFAULT_COLORS = [(0.85, 0.45, 0.25), (0.4, 0.6, 0.9), (0.5, 0.8, 0.5)]


# -- batched forward kinematics ----------------------------------------------

def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _qmul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _qrot(q, v):
    w, u = q[..., :1], q[..., 1:]
    t = _cross(u, v.expand_as(u))
    return v + 2.0 * (w * t + _cross(u, t))


def _qnorm(q):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1,
                                                    keepdim=True), min=1e-12)


class _Tables:
    """The model's float leaves in float64 on one device."""

    def __init__(self, m: Model, device):
        def f64(t):
            return t.detach().to(device=device, dtype=_F64)
        self.qpos0 = f64(m.qpos0)
        self.body_pos, self.body_quat = f64(m.body_pos), f64(m.body_quat)
        self.jnt_pos, self.jnt_axis = f64(m.jnt_pos), f64(m.jnt_axis)
        self.geom_pos, self.geom_quat = f64(m.geom_pos), f64(m.geom_quat)
        self.geom_size = f64(m.geom_size)
        self.geom_bodyid = torch.as_tensor(np.asarray(m.geom_bodyid, np.int64),
                                           device=device)


def fk(m: Model, qpos: torch.Tensor, tables: Optional[_Tables] = None):
    """Batched FK: qpos (N, nq) -> xpos (N, nbody, 3), xquat (N, nbody, 4),
    geom_xpos (N, ngeom, 3), geom_xmat (N, ngeom, 3, 3), in float64 on
    qpos's device.  The JAX package's host FK (``numpy_fk``) with the
    frames as the batch: parent offset, then the body's joints applied in
    its local frame (hinge and slide deltas relative to qpos0)."""
    qpos = qpos.to(_F64)
    tb = tables or _Tables(m, qpos.device)
    n = qpos.shape[0]
    unit = qpos.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(n, 4)
    xpos, xquat = [qpos.new_zeros(n, 3)], [unit]
    for b in range(1, m.nbody):
        p = int(m.body_parentid[b])
        pos = xpos[p] + _qrot(xquat[p], tb.body_pos[b])
        quat = _qmul(xquat[p], tb.body_quat[b].expand(n, 4))
        adr, num = int(m.body_jntadr[b]), int(m.body_jntnum[b])
        for j in range(adr, adr + num):
            jt = int(m.jnt_type[j])
            qa = int(m.jnt_qposadr[j])
            if jt == int(JointType.FREE):
                pos = qpos[:, qa:qa + 3]
                quat = _qnorm(qpos[:, qa + 3:qa + 7])
                continue
            if jt == int(JointType.SLIDE):
                pos = pos + _qrot(quat, tb.jnt_axis[j]
                                  * (qpos[:, qa:qa + 1] - tb.qpos0[qa]))
                continue
            if jt == int(JointType.BALL):
                q_loc = _qnorm(qpos[:, qa:qa + 4])
            else:  # HINGE
                half = 0.5 * (qpos[:, qa:qa + 1] - tb.qpos0[qa])
                q_loc = torch.cat([torch.cos(half),
                                   torch.sin(half) * tb.jnt_axis[j]], -1)
            pos = pos + _qrot(quat, tb.jnt_pos[j]
                              - _qrot(q_loc, tb.jnt_pos[j]))
            quat = _qmul(quat, q_loc)
        xpos.append(pos)
        xquat.append(_qnorm(quat))
    xpos, xquat = torch.stack(xpos, 1), torch.stack(xquat, 1)
    gb = tb.geom_bodyid
    gxpos = xpos[:, gb] + _qrot(xquat[:, gb], tb.geom_pos)
    gxmat = quat_to_mat(_qmul(xquat[:, gb],
                              tb.geom_quat.expand(n, -1, 4)))
    return xpos, xquat, gxpos, gxmat


def numpy_fk(m: Model, qpos: np.ndarray):
    """Host FK: qpos (nq,) -> (xpos (nb,3), xquat (nb,4), geom_xpos,
    geom_xmat) as float64 numpy, as vnl_tpu.render.software.numpy_fk
    returns them (:func:`fk` on the CPU)."""
    q = torch.as_tensor(np.asarray(qpos, np.float64))
    out = fk(m, q[None], _Tables(m, "cpu"))
    return tuple(x[0].numpy() for x in out)


def _look_at(eye, target, up=(0.0, 0.0, 1.0)):
    """eye, target (F, 3) -> camera rows (right, up, forward) (F, 3, 3)."""
    f = target - eye
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    r = _cross(f, f.new_tensor(up).expand_as(f))
    n = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    # looking straight up or down: any horizontal right
    r = torch.where(n < 1e-9, f.new_tensor([1.0, 0.0, 0.0]),
                    r / torch.where(n < 1e-9, 1.0, n))
    u = _cross(r, f)
    return torch.stack([r, u, f], -2)


# -- analytic ray/geom intersections -----------------------------------------
# Origins O and directions D (..., 3) in the GEOM LOCAL frame, sizes
# broadcasting against the leading dims; each returns (t, normal_local) with
# t = inf on a miss, or t alone without ``normal``.  Only t >= _TMIN counts.

def _quadratic(a, b, c):
    """Smallest root >= _TMIN of a t^2 + 2 b t + c = 0, else inf."""
    disc = b * b - a * c
    ok = disc >= 0
    sq = torch.sqrt(torch.where(ok, disc, 0.0))
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    t = torch.where(t0 >= _TMIN, t0, t1)
    return torch.where(ok & (t >= _TMIN), t, _INF)


def _finite(t):
    return torch.where(torch.isfinite(t), t, 0.0)


def _ray_sphere(O, D, radius, normal=True):
    t = _quadratic(1.0, _dot(D, O), _dot(O, O) - radius * radius)
    return (t, O + _finite(t)[..., None] * D) if normal else t


def _ray_ellipsoid(O, D, size, normal=True):
    Os, Ds = O / size, D / size
    t = _quadratic(torch.clamp(_dot(Ds, Ds), min=1e-12), _dot(Ds, Os),
                   _dot(Os, Os) - 1.0)
    if not normal:
        return t
    hit = O + _finite(t)[..., None] * D
    return t, hit / (size * size)  # gradient of the implicit surface


def _ray_capped_cylinder(O, D, radius, half, spherical_caps, normal=True):
    """Cylinder of ``radius`` along local z in [-half, half]; caps are
    hemispheres (capsule) or flat discs (cylinder)."""
    a = D[..., 0] ** 2 + D[..., 1] ** 2
    b = D[..., 0] * O[..., 0] + D[..., 1] * O[..., 1]
    c = O[..., 0] ** 2 + O[..., 1] ** 2 - radius * radius
    t_side = _quadratic(torch.clamp(a, min=1e-12), b, c)
    z = O[..., 2] + _finite(t_side) * D[..., 2]
    t = torch.where(torch.abs(z) <= half, t_side, _INF)
    n = None
    if normal:
        n = (O + _finite(t)[..., None] * D) * O.new_tensor([1.0, 1.0, 0.0])
    zero = torch.zeros_like(half)
    if spherical_caps:
        for sz in (-half, half):
            cap = torch.stack([zero, zero, sz], -1)
            out = _ray_sphere(O - cap, D, radius, normal)
            tc, nc = out if normal else (out, None)
            closer = tc < t
            t = torch.where(closer, tc, t)
            if normal:
                n = torch.where(closer[..., None], nc, n)
        return (t, n) if normal else t
    dz = D[..., 2]
    steep = torch.abs(dz) > 1e-12
    safe = torch.where(steep, dz, 1.0)
    for sz in (-half, half):
        tc = (sz - O[..., 2]) / safe
        px = O[..., 0] + tc * D[..., 0]
        py = O[..., 1] + tc * D[..., 1]
        ok = steep & (tc >= _TMIN) & (px * px + py * py <= radius * radius)
        tc = torch.where(ok, tc, _INF)
        closer = tc < t
        t = torch.where(closer, tc, t)
        if normal:
            nc = torch.stack([zero, zero, torch.sign(sz)], -1)
            n = torch.where(closer[..., None], nc.expand_as(n), n)
    return (t, n) if normal else t


def _ray_box(O, D, size, normal=True):
    """Slab method; the normal is the axis of the entry face."""
    safe = torch.where(torch.abs(D) > 1e-12, D, 1e-12)
    t1 = (-size - O) / safe
    t2 = (size - O) / safe
    tlo = torch.minimum(t1, t2)
    t_near, axis = tlo.max(-1)
    t_far = torch.maximum(t1, t2).min(-1).values
    hit = (t_near <= t_far) & (t_far >= _TMIN)
    # camera inside the box renders the exit face
    t = torch.where(t_near >= _TMIN, t_near, t_far)
    t = torch.where(hit, t, _INF)
    if not normal:
        return t
    onehot = torch.nn.functional.one_hot(axis, 3).bool()
    return t, torch.where(onehot, -torch.sign(D), 0.0)


def _intersect(gtype: int, O, D, size, normal=True):
    """One geom type's intersection; ``size`` (..., 3)."""
    if gtype == int(GeomType.SPHERE):
        return _ray_sphere(O, D, size[..., 0], normal)
    if gtype == int(GeomType.CAPSULE):
        return _ray_capped_cylinder(O, D, size[..., 0], size[..., 1], True,
                                    normal)
    if gtype == int(GeomType.CYLINDER):
        return _ray_capped_cylinder(O, D, size[..., 0], size[..., 1], False,
                                    normal)
    if gtype == int(GeomType.ELLIPSOID):
        return _ray_ellipsoid(O, D, size, normal)
    return _ray_box(O, D, size, normal)


_CAST_TYPES = tuple(int(t) for t in (GeomType.SPHERE, GeomType.CAPSULE,
                                     GeomType.CYLINDER, GeomType.ELLIPSOID,
                                     GeomType.BOX))


def _enumerate_rects(x0, y0, bw, bh):
    """The pixels of a batch of rects (x0, y0, width, height), any shape,
    as entries: (flat index of the rect, px, py), rect by rect in row
    order.  An empty rect has width or height 0."""
    bw, bh = bw.reshape(-1), bh.reshape(-1)
    counts = bw * bh
    rect = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts)
    start = torch.cumsum(counts, 0) - counts
    local = torch.arange(rect.shape[0], device=counts.device) - start[rect]
    px = x0.reshape(-1)[rect] + local % bw[rect]
    py = y0.reshape(-1)[rect] + local // bw[rect]
    return rect, px, py


def _nearest(npix: int, pix, t, ids, nid: int, dtype):
    """Per pixel of ``npix``: the least t over the entries (pix, t, id),
    and the least id among the entries at that t (``nid`` where none)."""
    depth = torch.full((npix,), _INF, dtype=dtype,
                       device=pix.device).scatter_reduce(0, pix, t, "amin")
    at_min = (t == depth[pix]) & torch.isfinite(t)
    winner = torch.full((npix,), nid, dtype=torch.long,
                        device=pix.device).scatter_reduce(
        0, pix[at_min], ids[at_min], "amin")
    return depth, winner


class SoftwareRenderer:
    def __init__(self, model: Model, width: int = 320, height: int = 240,
                 fovy: float = 45.0, skin=None, device=None,
                 chunk_bytes: int = CHUNK_BYTES):
        """skin: optional render.skin.Skin; when set, instances render the
        skinned mesh (z-buffered triangles) instead of collision geoms.
        ``skin="auto"`` reads the model's ``skin_file`` if it has one.
        ``device``: where the frames are cast (default: the model's)."""
        self.m = model
        self.w, self.h = width, height
        self.focal = 0.5 * height / np.tan(np.deg2rad(fovy) / 2)
        self.device = torch.device(device if device is not None
                                   else model.device)
        self.chunk_bytes = chunk_bytes
        if skin == "auto":
            skin = None
            path = getattr(model, "skin_file", None)
            if path:
                try:
                    from vnl_tpu_torch.render.skin import load_skn
                    skin = load_skn(path)
                except (OSError, ValueError):
                    skin = None  # missing/corrupt asset: fall back to geoms
        self.skin = skin
        dev = self.device
        if skin is not None:
            from vnl_tpu_torch.render.skin import bone_body_ids
            self._skin_bones = bone_body_ids(skin, model.body_names)
            self._faces = torch.as_tensor(skin.faces.astype(np.int64),
                                          device=dev)
        self._tables = _Tables(model, dev)
        gt = np.asarray(model.geom_type)
        self._gtype = torch.as_tensor(gt.astype(np.int64), device=dev)
        # the geoms cast (planes are the ground's), by type group
        self._groups = [(k, torch.as_tensor(np.nonzero(gt == k)[0],
                                            device=dev))
                        for k in _CAST_TYPES if (gt == k).any()]
        self._rbound = model.geom_rbound.detach().to(dev, _F64)
        yy, xx = torch.meshgrid(torch.arange(height, dtype=_F64, device=dev),
                                torch.arange(width, dtype=_F64, device=dev),
                                indexing="ij")
        self._dirs_cam = torch.stack([
            (xx - width / 2) / self.focal, -(yy - height / 2) / self.focal,
            torch.ones_like(xx)], -1).reshape(-1, 3)

    def geom_poses(self, qpos: np.ndarray):
        _, _, gxpos, gxmat = numpy_fk(self.m, np.asarray(qpos))
        return gxpos, gxmat

    # -- rays -----------------------------------------------------------------
    def _rays(self, R):
        """R (F, 3, 3) camera rows -> unit world directions (F, P, 3)."""
        dirs = self._dirs_cam @ R
        return dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)

    def _geom_pixel_window(self, R, eye, center, rbound):
        """The pixel rect covering each geom's projected bounding sphere
        plus 2 px, (x0, y0, width, height) each (F, G); empty where the
        geom is off-screen or behind the camera.  The JAX renderer's
        culling window, truncated to ints the same way."""
        pc = torch.einsum("fij,fgj->fgi", R, center - eye[:, None])
        z = pc[..., 2]
        seen = z + rbound > 1e-3
        z = torch.clamp(z, min=1e-3)
        u = self.w / 2 + self.focal * pc[..., 0] / z
        v = self.h / 2 - self.focal * pc[..., 1] / z
        pr = self.focal * rbound / z + 2.0
        x0 = torch.trunc(torch.clamp(u - pr, min=0.0)).long()
        x1 = torch.trunc(torch.clamp(u + pr + 1, max=float(self.w))).long()
        y0 = torch.trunc(torch.clamp(v - pr, min=0.0)).long()
        y1 = torch.trunc(torch.clamp(v + pr + 1, max=float(self.h))).long()
        empty = ~seen | (x0 >= x1) | (y0 >= y1)
        return (x0, y0, torch.where(empty, 0, x1 - x0),
                torch.where(empty, 0, y1 - y0))

    # -- passes ---------------------------------------------------------------
    def _cast_instance(self, dirs, eye, R, gx, gm):
        """Nearest geom hit per pixel for one instance in every frame of the
        chunk: (t (F, P), normal (F, P, 3)); t = inf and normal 0 where no
        geom is hit.  A geom is cast only at the pixels of its culling
        window: each (frame, geom, pixel of the window) is one entry.  At
        equal t the lower geom id wins, as the JAX loop's strict ``<`` in
        geom order keeps it."""
        F, P = dirs.shape[:2]
        if not self._groups:                 # nothing but the ground
            return dirs.new_full((F, P), _INF), torch.zeros_like(dirs)
        size = self._tables.geom_size
        flat_dirs = dirs.reshape(F * P, 3)
        pix, ts, gids = [], [], []
        for k, g in self._groups:
            x0, y0, bw, bh = self._geom_pixel_window(R, eye, gx[:, g],
                                                     self._rbound[g])
            rect, px, py = _enumerate_rects(x0, y0, bw, bh)
            f, gid = rect // len(g), g[rect % len(g)]
            p = f * P + py * self.w + px
            Rg = gm[f, gid]                                   # (E, 3, 3)
            Dl = torch.einsum("ei,eij->ej", flat_dirs[p], Rg)
            Ol = torch.einsum("ei,eij->ej", eye[f] - gx[f, gid], Rg)
            pix.append(p)
            ts.append(_intersect(k, Ol, Dl, size[gid], normal=False))
            gids.append(gid)
        depth, winner = _nearest(F * P, torch.cat(pix), torch.cat(ts),
                                 torch.cat(gids), self.m.ngeom, dirs.dtype)
        # the winners' normals: their intersection again, one a pixel
        hp = torch.nonzero(winner < self.m.ngeom).squeeze(-1)
        f, gid = hp // P, winner[hp]
        Rg = gm[f, gid]
        Dl = torch.einsum("ei,eij->ej", flat_dirs[hp], Rg)
        Ol = torch.einsum("ei,eij->ej", eye[f] - gx[f, gid], Rg)
        types = self._gtype[gid]
        n_local = torch.zeros_like(Dl)
        for k, _ in self._groups:
            _, nk = _intersect(k, Ol, Dl, size[gid])
            n_local = torch.where((types == k)[:, None], nk, n_local)
        n = torch.zeros_like(flat_dirs)
        n[hp] = torch.einsum("eij,ej->ei", Rg, n_local)
        return depth.reshape(F, P), n.reshape(F, P, 3)

    def _raster_skin(self, eye, R, xpos, xquat):
        """Rasterises the posed skin mesh with a z-buffer (flat shading),
        every frame of the chunk at once: (t (F, P), normal (F, P, 3)) as
        :meth:`_cast_instance` gives them.  t is the Euclidean distance from
        the eye interpolated barycentrically.  Each (frame, face, pixel of
        the face's bounding box) is one entry; the depth is reduced per
        pixel with ``scatter_reduce`` amin, then the normal is that of the
        face that reached the minimum.  Ties: the lowest face id at the
        minimum depth (an amin over the ids of the faces at that depth),
        which is the face the JAX loop keeps, since its strict ``<`` in
        face order leaves the first face at equal depth in place."""
        from vnl_tpu_torch.render.skin import skin_vertices
        F = eye.shape[0]
        H, W = self.h, self.w
        verts = skin_vertices(self.skin, self._skin_bones, xpos, xquat)
        rel = verts - eye[:, None]
        cam = torch.einsum("fvj,fij->fvi", rel, R)          # right, up, fwd
        z = torch.clamp(cam[..., 2], min=1e-3)
        u = W / 2 + self.focal * cam[..., 0] / z
        v = H / 2 - self.focal * cam[..., 1] / z
        tv = torch.linalg.vector_norm(rel, dim=-1)
        valid = cam[..., 2] > 1e-3

        faces = self._faces
        nf = faces.shape[0]
        p0, p1, p2 = (verts[:, faces[:, k]] for k in range(3))
        fn = _cross(p1 - p0, p2 - p0)
        # every face normal toward the camera (winding-agnostic)
        toward = _dot(fn, (p0 + p1 + p2) / 3 - eye[:, None])
        fn = torch.where(toward[..., None] > 0, -fn, fn).reshape(F * nf, 3)

        uf, vf = u[:, faces], v[:, faces]                     # (F, nf, 3)
        xa = torch.clamp(torch.trunc(uf.min(-1).values).long(), min=0)
        xb = torch.clamp(torch.trunc(uf.max(-1).values).long() + 2, max=W)
        ya = torch.clamp(torch.trunc(vf.min(-1).values).long(), min=0)
        yb = torch.clamp(torch.trunc(vf.max(-1).values).long() + 2, max=H)
        x0f, x1f, x2f = uf.reshape(F * nf, 3).unbind(-1)
        y0f, y1f, y2f = vf.reshape(F * nf, 3).unbind(-1)
        denom = (y1f - y2f) * (x0f - x2f) + (x2f - x1f) * (y0f - y2f)
        keep = (valid[:, faces].all(-1).reshape(-1) & (xa < xb).reshape(-1)
                & (ya < yb).reshape(-1) & (torch.abs(denom) >= 1e-9))
        bw = torch.where(keep, (xb - xa).reshape(-1), 0)
        e, pxi, pyi = _enumerate_rects(xa, ya, bw, (yb - ya).reshape(-1))
        px, py = pxi.to(_F64) + 0.5, pyi.to(_F64) + 0.5
        X0, X1, X2, Y0, Y1, Y2 = (c[e] for c in (x0f, x1f, x2f,
                                                  y0f, y1f, y2f))
        l0 = ((Y1 - Y2) * (px - X2) + (X2 - X1) * (py - Y2)) / denom[e]
        l1 = ((Y2 - Y0) * (px - X2) + (X0 - X2) * (py - Y2)) / denom[e]
        l2 = 1.0 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        tfe = tv[:, faces].reshape(F * nf, 3)[e]
        t_pix = l0 * tfe[:, 0] + l1 * tfe[:, 1] + l2 * tfe[:, 2]
        pix = ((e // nf) * H + pyi) * W + pxi
        depth, winner = _nearest(F * H * W, pix[inside], t_pix[inside],
                                 (e % nf)[inside], nf, eye.dtype)
        frame = torch.arange(F, device=eye.device).repeat_interleave(H * W)
        n = torch.where((winner < nf)[:, None],
                        fn[frame * nf + winner.clamp(max=nf - 1)], 0.0)
        return depth.reshape(F, H * W), n.reshape(F, H * W, 3)

    @staticmethod
    def _shade(normals, base_color):
        n = normals / torch.clamp(torch.linalg.vector_norm(
            normals, dim=-1, keepdim=True), min=1e-9)
        lam = torch.clamp(_dot(n, n.new_tensor(_LIGHT)), 0.0, 1.0)
        shade = 0.45 + 0.55 * lam
        return shade[..., None] * n.new_tensor(base_color) * 255.0

    def _draw_ground(self, img, depth, dirs, eye, cell: float = 0.1):
        """Checkerboard ground plane z = 0 by per-pixel ray casting, its
        pattern faded with distance (no moire near the horizon)."""
        dz = dirs[..., 2]
        downward = dz < -1e-6
        ez = eye[:, 2:3]
        t = torch.where(downward, -ez / torch.where(downward, dz, -1.0),
                        _INF)
        hit = downward & (t >= _TMIN)
        ts = torch.where(hit, t, 0.0)  # finite placeholder where unused
        px = eye[:, :1] + ts * dirs[..., 0]
        py = eye[:, 1:2] + ts * dirs[..., 1]
        checker = torch.remainder(torch.floor(px / cell)
                                  + torch.floor(py / cell), 2)
        fade = 1.0 / (1.0 + (ts / (80.0 * cell)) ** 2)
        shade_val = 235.0 - (235.0 - 210.0) * checker * fade
        img = torch.where(hit[..., None], shade_val[..., None].float(), img)
        return img, torch.where(hit, t, depth)

    # -- frames ---------------------------------------------------------------
    def _frame_bytes(self, R, eye, gx) -> torch.Tensor:
        """(F,) estimated bytes of one frame's temporaries: its entries
        (window pixels of every geom and instance, or skin-face boxes) and
        its pixel buffers, at _ENTRY_BYTES and _PIXEL_BYTES each."""
        F, I = gx.shape[:2]
        npix = torch.full((F,), self.w * self.h * _PIXEL_BYTES,
                          device=self.device)
        if self.skin is not None:
            return npix + I * self._faces.shape[0] * 64 * _ENTRY_BYTES
        area = torch.zeros(F, device=self.device)
        for i in range(I):
            _, _, bw, bh = self._geom_pixel_window(R, eye, gx[:, i],
                                                   self._rbound)
            area += (bw * bh).sum(-1)
        return npix + area * _ENTRY_BYTES

    def render_frames(self, qpos: torch.Tensor,
                      camera_pos: Optional[torch.Tensor] = None,
                      camera_target: Optional[torch.Tensor] = None,
                      colors: Optional[Sequence[Tuple[float, float,
                                                      float]]] = None,
                      alphas: Optional[Sequence[float]] = None
                      ) -> torch.Tensor:
        """Renders F frames, each with I model instances overlaid.

        qpos: (F, I, nq); instance 0 is opaque (the agent), later instances
        render translucent (the reference ghost).  camera_pos and
        camera_target: (3,) or (F, 3); by default the camera looks at
        instance 0's root from a fixed offset.  Returns (F, H, W, 3) uint8
        on the renderer's device.  The frames are cast in chunks whose
        temporaries stay under ``chunk_bytes``."""
        qpos = torch.as_tensor(qpos).to(self.device, _F64)
        F, I = qpos.shape[:2]
        root0 = qpos[:, 0, :3]
        if camera_target is None:
            camera_target = root0
        else:
            camera_target = torch.as_tensor(camera_target).to(
                self.device, _F64).expand(F, 3)
        if camera_pos is None:
            scale = max(0.3, float(self.m.geom_rbound.abs().max() * 10))
            camera_pos = root0 + root0.new_tensor(
                [scale, -scale, 0.6 * scale])
        else:
            camera_pos = torch.as_tensor(camera_pos).to(
                self.device, _F64).expand(F, 3)
        R = _look_at(camera_pos, camera_target)
        xpos, xquat, gx, gm = (
            x.reshape(F, I, *x.shape[1:])
            for x in fk(self.m, qpos.reshape(F * I, -1), self._tables))
        cost = self._frame_bytes(R, camera_pos, gx).cpu().numpy()
        out, s = [], 0
        while s < F:            # as many frames as fit, at least one
            e = s + 1
            while e < F and cost[s:e + 1].sum() <= self.chunk_bytes:
                e += 1
            sl = slice(s, e)
            out.append(self._render_chunk(
                R[sl], camera_pos[sl], xpos[sl], xquat[sl], gx[sl], gm[sl],
                colors, alphas))
            s = e
        return torch.cat(out).reshape(F, self.h, self.w, 3)

    def _render_chunk(self, R, eye, xpos, xquat, gx, gm, colors, alphas):
        I = xpos.shape[1]
        dirs = self._rays(R)

        # background + checkerboard ground into the z-buffer
        img = dirs.new_full(dirs.shape, 255.0, dtype=torch.float32)
        depth = dirs.new_full(dirs.shape[:2], _INF)
        img, depth = self._draw_ground(img, depth, dirs, eye)

        inst_alpha = [(alphas[i] if alphas else (1.0 if i == 0 else 0.45))
                      for i in range(I)]
        inst_color = [tuple(colors[i] if colors else _DEFAULT_COLORS[i % 3])
                      for i in range(I)]

        def instance_buffers(i):
            if self.skin is not None:
                return self._raster_skin(eye, R, xpos[:, i], xquat[:, i])
            return self._cast_instance(dirs, eye, R, gx[:, i], gm[:, i])

        # opaque pass (all instances with alpha >= 1) -> depth buffer
        for i in range(I):
            if inst_alpha[i] < 1.0:
                continue
            t, n = instance_buffers(i)
            closer = t < depth
            depth = torch.where(closer, t, depth)
            shaded = self._shade(n, inst_color[i])
            img = torch.where(closer[..., None], shaded.float(), img)

        # translucent passes blend against the opaque depth buffer (in
        # float32, then float64 with the shade, as numpy promotes it)
        for i in range(I):
            a = inst_alpha[i]
            if a >= 1.0:
                continue
            t, n = instance_buffers(i)
            vis = t < depth
            shaded = self._shade(n, inst_color[i])
            blend = (((1 - a) * img).double() + a * shaded).float()
            img = torch.where(vis[..., None], blend, img)

        return torch.clamp(img, 0, 255).to(torch.uint8)

    def render(self, qpos_list: Sequence[np.ndarray],
               camera_pos: Optional[np.ndarray] = None,
               camera_target: Optional[np.ndarray] = None,
               colors: Optional[Sequence[Tuple[float, float, float]]] = None,
               alphas: Optional[Sequence[float]] = None) -> np.ndarray:
        """Renders one frame with one or more model instances overlaid
        (instance 0 opaque, later ones translucent); (H, W, 3) uint8 numpy,
        as the JAX renderer's ``render`` returns it."""
        q = torch.as_tensor(np.stack([np.asarray(x, np.float64)
                                      for x in qpos_list]))[None]
        as64 = (lambda x: None if x is None
                else torch.as_tensor(np.asarray(x, np.float64)))
        return self.render_frames(q, as64(camera_pos), as64(camera_target),
                                  colors, alphas)[0].cpu().numpy()


def render_egocentric(model: Model, qpos: np.ndarray,
                      body_name: str = "skull", width: int = 64,
                      height: int = 64, forward_offset: float = 0.3,
                      renderer: Optional[SoftwareRenderer] = None,
                      device=None) -> np.ndarray:
    """64x64 egocentric view from a head/skull body (offline analysis and
    visualisation, not a training observation; the batched training-time
    camera is render/jit_camera.py)."""
    r = renderer or SoftwareRenderer(model, width, height, fovy=90.0,
                                     device=device)
    xpos, xquat, _, _ = numpy_fk(model, np.asarray(qpos))
    bid = model.body_names.index(body_name)
    pos = xpos[bid]
    fwd = quat_to_mat(torch.as_tensor(xquat[bid])).numpy()[:, 0]  # body x
    return r.render([np.asarray(qpos)], camera_pos=pos + 0.02 * fwd,
                    camera_target=pos + forward_offset * fwd)


def render_trajectory(model: Model, qpos_traj: np.ndarray, width=320,
                      height=240, device=None, **kwargs) -> np.ndarray:
    """(T, nq) -> (T, H, W, 3) uint8 frames (numpy); ``kwargs`` as
    :meth:`SoftwareRenderer.render_frames` takes them, for every frame."""
    r = SoftwareRenderer(model, width, height, device=device)
    q = torch.as_tensor(np.asarray(qpos_traj, np.float64))[:, None]
    return r.render_frames(q, **kwargs).cpu().numpy()


def overlay_frames(model: Model, qpos_rollout: np.ndarray,
                   qpos_ref: np.ndarray, width=320, height=240,
                   skin="auto", device=None) -> torch.Tensor:
    """The agent vs reference ghost overlay: the same model rendered twice
    a frame (agent opaque, reference translucent), (T, H, W, 3) uint8 on
    ``device`` (default: the model's); T is the shorter of the two."""
    if isinstance(skin, str) and skin != "auto":
        from vnl_tpu_torch.render.skin import load_skn
        skin = load_skn(skin)
    r = SoftwareRenderer(model, width, height, skin=skin, device=device)
    qa, qr = np.asarray(qpos_rollout), np.asarray(qpos_ref)
    n = min(len(qa), len(qr))
    return r.render_frames(
        torch.as_tensor(np.stack([qa[:n], qr[:n]], 1).astype(np.float64)))


def write_video(frames: np.ndarray, out_path: str, fps: int = 50) -> str:
    """Writes (T, H, W, 3) uint8 frames with imageio; without its mp4
    backend, a .gif beside ``out_path``, as the JAX package does; without
    imageio itself, that .gif by ``utils.images.write_gif`` (3-3-2
    colours).  Returns the path written."""
    gif = out_path.rsplit(".", 1)[0] + ".gif"
    try:
        import imageio
    except ImportError:
        from vnl_tpu_torch.utils.images import write_gif
        return write_gif(gif, frames, fps)
    try:
        imageio.mimsave(out_path, list(frames), fps=fps)
    except (ValueError, ImportError):
        # no ffmpeg backend in this environment: degrade to GIF
        imageio.mimsave(gif, list(frames), duration=1.0 / fps)
        out_path = gif
    return out_path


def render_overlay_video(model: Model, qpos_rollout: np.ndarray,
                         qpos_ref: np.ndarray, out_path: str,
                         fps: int = 50, width=320, height=240,
                         skin="auto", device=None) -> str:
    """Agent vs reference ghost overlay video (:func:`overlay_frames`,
    :func:`write_video`).  skin: optional render.skin.Skin, or a path to a
    .skn file.  Returns the path written."""
    frames = overlay_frames(model, qpos_rollout, qpos_ref, width, height,
                            skin, device).cpu().numpy()
    return write_video(frames, out_path, fps)
