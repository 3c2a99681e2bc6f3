"""Kernel E: the narrowphase of every candidate pair of a substep in one
launch.

``collide(m, geom_xpos, geom_xmat)`` maps the geoms' positions (B, ngeom, 3)
and rotations (B, ngeom, 3, 3) to what physics/collision.py collide
returns: dist (B, ncon), pos (B, ncon, 3), frame (B, ncon, 3, 3), float32
and contiguous, and con_pair, in the plain version's slot order.  It
launches csrc/collision.cu and takes CUDA float32 tensors only;
physics/collision.py collide sends CUDA tensors here and runs its plain
version, ``collide_plain``, on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vnl_tpu_torch.ops import build, launch_counts
from vnl_tpu_torch.physics import collision
from vnl_tpu_torch.physics.model import GeomType, Model

THREADS = 128       # kThreads of the source: one thread a (env, pair)
# the pair types in the source's PairType order: collision._ORDER's
PAIR_TYPES = tuple((a, b) for a, b, _ in collision._ORDER)
# the fields of the int table, in the order of the source's PairI
PAIR_FIELDS = ("type", "g1", "g2", "slot", "stride")
BOX_TYPES = {(GeomType.PLANE, GeomType.BOX), (GeomType.BOX, GeomType.BOX)}


def kernel_tables(m: Model) -> dict:
    """Static tables of kernel E for one model, its candidate pairs in the
    plain version's group order (collision._groups):
      pair_int (len(PAIR_FIELDS), npair): the pair's type (its index in
        PAIR_TYPES), its two geoms, the slot of its first point and the
        stride to its next point;
      pair_size (6, npair): both geoms' sizes, float32;
      pair (npair,): each row's candidate pair;
      con_pair: collision.pair_expansion(m);
      boxes: whether a pair type holds a box (the kernel's kBoxes).
    Point j of a row lands in slot ``slot + j * stride``: a row's first
    slot is where pair_expansion first names its pair, and the stride the
    number of pairs in its group (collide emits a group's points as one
    block of the group's pairs per point)."""
    con_pair = collision.pair_expansion(m)
    first = {}
    for slot, p in enumerate(con_pair.tolist()):
        first.setdefault(p, slot)
    groups = collision._groups(m)
    pair = np.concatenate([idx for *_, idx in groups])
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
        boxes=any((a, b) in BOX_TYPES for a, b, _, _ in groups))


class ColModel(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("npair", "ngeom", "ncon")]
                + [(n, ctypes.c_void_p) for n in ("pair_int", "pair_size")])


class ColIn(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("geom_xpos", "geom_xmat")]


class ColOut(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("dist", "pos", "frame")]


def _device_model(m: Model, device: torch.device):
    """(ColModel struct, tables) with the tables on ``device``, made once
    per model."""
    key = ("collision_kernel", str(device))
    if key not in m.cache:
        t = kernel_tables(m)
        held = {n: torch.as_tensor(np.ascontiguousarray(t[n]), device=device)
                for n in ("pair_int", "pair_size")}
        st = ColModel(npair=len(t["pair"]), ngeom=m.ngeom,
                      ncon=len(t["con_pair"]),
                      **{n: held[n].data_ptr() for n in held})
        m.cache[key] = (st, t, held)
    return m.cache[key][:2]


def resources(m: Model) -> dict:
    """Registers per thread, local (spill) bytes, shared memory per block
    and resident blocks per SM of both instantiations of kernel E, by
    kBoxes ("boxes", "no_boxes"), and the one this model takes."""
    st, t = _device_model(m, m.device)
    return dict(boxes=build.resources("collision", st, 1),
                no_boxes=build.resources("collision", st, 0),
                takes="boxes" if t["boxes"] else "no_boxes",
                threads=THREADS)


def collide(m: Model, geom_xpos: torch.Tensor, geom_xmat: torch.Tensor):
    """Kernel E on a batch: (dist (B, ncon), pos (B, ncon, 3), frame
    (B, ncon, 3, 3), con_pair numpy (ncon,))."""
    B, dev = geom_xpos.shape[0], geom_xpos.device
    for name, a, s in (("geom_xpos", geom_xpos, (m.ngeom, 3)),
                       ("geom_xmat", geom_xmat, (m.ngeom, 3, 3))):
        if (a.dtype != torch.float32 or tuple(a.shape) != (B,) + s
                or not a.is_contiguous() or not a.is_cuda
                or a.device != dev):
            raise ValueError(f"kernel E: {name} must be contiguous float32 "
                             f"{(B,) + s} on a CUDA device ({dev}), got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}"
                             f"{'' if a.is_contiguous() else ', strided'}")
    if dev != m.device:
        raise ValueError(f"kernel E: geoms on {dev}, model on {m.device}")
    st, t = _device_model(m, dev)
    nc = st.ncon
    dist = torch.empty(B, nc, device=dev)
    pos = torch.empty(B, nc, 3, device=dev)
    frame = torch.empty(B, nc, 3, 3, device=dev)
    fn = build.load("collision").collision_launch
    fn.argtypes = [ColModel, ColIn, ColOut, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(fn(st, ColIn(geom_xpos.data_ptr(), geom_xmat.data_ptr()),
                   ColOut(dist.data_ptr(), pos.data_ptr(), frame.data_ptr()),
                   B, int(t["boxes"]), stream), "kernel E (collision)")
    launch_counts["collision"] += 1
    return dist, pos, frame, t["con_pair"]
