"""Kernel E: the narrowphase of every candidate pair of a substep in one
launch.

``collide(m, d)`` is forward's narrowphase.  On a CUDA device it launches
csrc/collision.cu on the geoms' positions (B, ngeom, 3) and rotations
(B, ngeom, 3, 3), in float32, and returns what physics/collision.py
collide, the plain version, returns everywhere else: dist (B, ncon), pos
(B, ncon, 3), frame (B, ncon, 3, 3), float32 and contiguous, and
con_pair, in the plain version's slot order.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vnl_tpu_torch.ops import build, capture_notes
from vnl_tpu_torch.physics import collision
from vnl_tpu_torch.physics.model import Data, GeomType, Model

THREADS = 128       # kThreads of the source: one thread a (env, pair)
# the pair types in the source's PairType order: collision._ORDER's
PAIR_TYPES = tuple((a, b) for a, b, _ in collision._ORDER)
# the fields of the int table, in the order of the source's PairI
PAIR_FIELDS = ("type", "g1", "g2", "slot", "stride")
BOX_TYPES = {(GeomType.PLANE, GeomType.BOX), (GeomType.BOX, GeomType.BOX)}
CONVEX_TYPES = {(GeomType.SPHERE, GeomType.ELLIPSOID),
                (GeomType.CAPSULE, GeomType.ELLIPSOID),
                (GeomType.ELLIPSOID, GeomType.ELLIPSOID)}
# the instantiations of the source, by route (bit 0 kBoxes, bit 1 kConvex);
# no scene has both box and convex pairs, and no instantiation takes them
ROUTES = {"no_boxes": 0, "boxes": 1, "convex": 2}
# the pair groups a capture notes (ops.capture_notes "pair_groups"), by
# the pair types each holds
PAIR_GROUPS = {
    "plane": {(GeomType.PLANE, t) for t in (GeomType.SPHERE, GeomType.CAPSULE,
                                            GeomType.ELLIPSOID,
                                            GeomType.CYLINDER)},
    "body": {(GeomType.SPHERE, GeomType.SPHERE),
             (GeomType.SPHERE, GeomType.CAPSULE),
             (GeomType.CAPSULE, GeomType.CAPSULE)},
    "box": BOX_TYPES | {(GeomType.SPHERE, GeomType.BOX)},
    "convex": CONVEX_TYPES}


def kernel_tables(m: Model) -> dict:
    """Static tables of kernel E for one model, its candidate pairs in the
    plain version's group order (collision._groups):
      pair_int (len(PAIR_FIELDS), npair): the pair's type (its index in
        PAIR_TYPES), its two geoms, the slot of its first point and the
        stride to its next point;
      pair_size (6, npair): both geoms' sizes, float32;
      pair (npair,): each row's candidate pair;
      con_pair: collision.pair_expansion(m);
      boxes: whether a pair type holds a box (the kernel's kBoxes);
      convex: whether a pair type is convex (CONVEX_TYPES, kConvex);
      route: the instantiation that takes them (ROUTES);
      pair_groups: the candidate pairs of each of PAIR_GROUPS.
    Point j of a row lands in slot ``slot + j * stride``: a row's first
    slot is where pair_expansion first names its pair, and the stride the
    number of pairs in its group (collide emits a group's points as one
    block of the group's pairs per point)."""
    con_pair = collision.pair_expansion(m)
    first = {}
    for slot, p in enumerate(con_pair.tolist()):
        first.setdefault(p, slot)
    groups = collision._groups(m)
    boxes = any((a, b) in BOX_TYPES for a, b, _, _ in groups)
    convex = any((a, b) in CONVEX_TYPES for a, b, _, _ in groups)
    if boxes and convex:
        raise NotImplementedError(
            "kernel E has no instantiation for box and convex pairs in one "
            "scene")
    pair = np.concatenate([idx for *_, idx in groups])
    # the convex pairs come last (collision._ORDER): the kernel takes the
    # last nconvex rows a warp a pair
    kinds = [(a, b) in CONVEX_TYPES for a, b, _, _ in groups]
    assert kinds == sorted(kinds)
    g1, g2 = np.asarray(m.pair_geom1)[pair], np.asarray(m.pair_geom2)[pair]
    pair_int = np.array(
        [[PAIR_TYPES.index((a, b)), len(idx)]
         for a, b, _, idx in groups for _ in idx], np.int64).T
    size = np.asarray(m.geom_size.detach().cpu(), np.float32)
    return dict(
        pair_int=np.stack([pair_int[0], g1, g2,
                           [first[p] for p in pair.tolist()],
                           pair_int[1]]).astype(np.int32),
        pair_size=np.ascontiguousarray(
            np.concatenate([size[g1], size[g2]], 1).T),
        pair=pair, con_pair=con_pair,
        boxes=boxes, convex=convex, route=int(boxes) | 2 * int(convex),
        pair_groups={name: sum(len(idx) for a, b, _, idx in groups
                               if (a, b) in types)
                     for name, types in PAIR_GROUPS.items()})


class ColModel(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("npair", "ngeom", "ncon",
                                             "nconvex")]
                + [(n, ctypes.c_void_p) for n in ("pair_int", "pair_size")])


class ColIn(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("geom_xpos", "geom_xmat")]


class ColOut(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("dist", "pos", "frame")]


def _device_model(m: Model, device: torch.device):
    """(ColModel struct, tables) with the tables on ``device``, made once
    per model."""
    def make(device):
        t = kernel_tables(m)
        held = build.on_device({n: t[n] for n in ("pair_int", "pair_size")},
                                device)
        return (ColModel(npair=len(t["pair"]), ngeom=m.ngeom,
                         ncon=len(t["con_pair"]),
                         nconvex=t["pair_groups"]["convex"],
                         **{n: held[n].data_ptr() for n in held}), t), held
    return build.tables(m, "collision", device, make)


def resources(m: Model) -> dict:
    """Registers per thread, local (spill) bytes, shared memory per block
    and resident blocks per SM of every instantiation of kernel E, by its
    name in ROUTES, and the one this model takes."""
    st, t = _device_model(m, m.device)
    out = {name: build.resources("collision", st, route)
           for name, route in ROUTES.items()}
    return dict(out, takes={r: n for n, r in ROUTES.items()}[t["route"]],
                threads=THREADS)


_ARGTYPES = (ColModel, ColIn, ColOut, ctypes.c_int, ctypes.c_int)


def _launch(m: Model, geom_xpos: torch.Tensor, geom_xmat: torch.Tensor):
    """Kernel E on a batch: (dist (B, ncon), pos (B, ncon, 3), frame
    (B, ncon, 3, 3), con_pair numpy (ncon,))."""
    B, dev = geom_xpos.shape[0], geom_xpos.device
    build.check_inputs("collision", m.device, (B,),
                 ("geom_xpos", geom_xpos, (m.ngeom, 3)),
                 ("geom_xmat", geom_xmat, (m.ngeom, 3, 3)))
    st, t = _device_model(m, dev)
    nc = st.ncon
    dist = torch.empty(B, nc, device=dev)
    pos = torch.empty(B, nc, 3, device=dev)
    frame = torch.empty(B, nc, 3, 3, device=dev)
    build.launch("collision", _ARGTYPES, dev, st,
                  ColIn(geom_xpos.data_ptr(), geom_xmat.data_ptr()),
                  ColOut(dist.data_ptr(), pos.data_ptr(), frame.data_ptr()),
                  B, t["route"])
    capture_notes["pair_groups"] = dict(t["pair_groups"])
    return dist, pos, frame, t["con_pair"]


def collide(m: Model, d: Data):
    """The narrowphase of a batch: kernel E on CUDA tensors (where the
    model has candidate pairs), the plain version elsewhere."""
    if m.ncon_max and d.geom_xpos.is_cuda:
        return _launch(m, d.geom_xpos.contiguous(), d.geom_xmat.contiguous())
    return collision.collide(m, d)
