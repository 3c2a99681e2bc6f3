"""MuJoCo binary skin (.skn) parsing and pose-driven vertex skinning
(PyTorch counterpart of vnl_tpu/render/skin.py).

- :func:`load_skn` parses MuJoCo's binary skin layout on the host (header
  ``int32 nvertex/ntexcoord/nface/nbone``, float vertex and texcoord
  tables, int32 faces, then one record a bone: 40-byte body name, bind pos
  (3f), bind quat (4f), vertex count, vertex ids, vertex weights), byte for
  byte as the JAX package reads it;
- :func:`skin_vertices` poses the mesh on the renderer's device, batched
  over frames: each vertex is the weight-blended sum over its bones of
  ``xpos_b + R(xquat_b) @ R(bindquat_b)^T @ (v - bindpos_b)``, MuJoCo's
  runtime skin update.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple

import numpy as np
import torch


class Skin(NamedTuple):
    verts: np.ndarray        # (V, 3) float32 bind-pose vertex positions
    faces: np.ndarray        # (F, 3) int32 triangle vertex ids
    bone_bodies: List[str]   # (nbone,) MJCF body name per bone
    bindpos: np.ndarray      # (nbone, 3)
    bindquat: np.ndarray     # (nbone, 4) (w, x, y, z), normalized
    weights: np.ndarray      # (V, nbone) dense, rows normalized to sum 1
    # vertex coordinates in each bone's bind frame: R(bindquat)^T (v - bindpos)
    local: np.ndarray        # (nbone, V, 3)


def _q2mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z) -> (..., 3, 3), the same products as
    :func:`_q2mat`."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def load_skn(path: str, scale: float = 1.0) -> Skin:
    """Parses a MuJoCo binary .skn file.

    scale: uniform rescale of the vertices and the bones' bind positions;
    pass the model's compile-time rescale factor (0.9 for the rodent) so
    the hide matches the rescaled skeleton (1.0 reproduces the reference,
    whose rescale leaves binary skin assets untouched)."""
    with open(path, "rb") as f:
        raw = f.read()
    nvert, ntex, nface, nbone = struct.unpack("<4i", raw[:16])
    off = 16
    verts = np.frombuffer(raw, "<f4", nvert * 3, off).reshape(nvert, 3)
    off += nvert * 12
    off += ntex * 8  # texcoords unused (flat shading)
    faces = np.frombuffer(raw, "<i4", nface * 3, off).reshape(nface, 3)
    off += nface * 12

    bone_bodies: List[str] = []
    bindpos = np.zeros((nbone, 3), np.float64)
    bindquat = np.zeros((nbone, 4), np.float64)
    weights = np.zeros((nvert, nbone), np.float64)
    for b in range(nbone):
        name = raw[off:off + 40].split(b"\0")[0].decode()
        off += 40
        bindpos[b] = struct.unpack("<3f", raw[off:off + 12])
        off += 12
        bindquat[b] = struct.unpack("<4f", raw[off:off + 16])
        off += 16
        (vn,) = struct.unpack("<i", raw[off:off + 4])
        off += 4
        vid = np.frombuffer(raw, "<i4", vn, off)
        off += vn * 4
        wgt = np.frombuffer(raw, "<f4", vn, off)
        off += vn * 4
        bone_bodies.append(name)
        weights[vid, b] += wgt

    bindquat /= np.maximum(
        np.linalg.norm(bindquat, axis=1, keepdims=True), 1e-12)
    if scale != 1.0:
        verts = (verts * np.float32(scale)).astype(np.float32)
        bindpos = bindpos * scale
    wsum = weights.sum(axis=1, keepdims=True)
    weights = weights / np.maximum(wsum, 1e-12)

    v64 = verts.astype(np.float64)
    local = np.stack([(v64 - bindpos[b]) @ _q2mat(bindquat[b])
                      for b in range(nbone)])  # row-vec form of R^T @ x
    return Skin(verts=verts, faces=np.ascontiguousarray(faces),
                bone_bodies=bone_bodies, bindpos=bindpos,
                bindquat=bindquat, weights=weights, local=local)


def bone_body_ids(skin: Skin, body_names) -> np.ndarray:
    """Maps each bone to its body id in a compiled Model (raises if a bone
    names a body the model doesn't have)."""
    names = list(body_names)
    return np.array([names.index(n) for n in skin.bone_bodies], np.int32)


def skin_vertices(skin: Skin, bone_ids, xpos: torch.Tensor,
                  xquat: torch.Tensor) -> torch.Tensor:
    """Poses the skin: world-space vertices (F, V, 3) from body FK results
    xpos (F, nbody, 3) and xquat (F, nbody, 4), on their device and in
    their dtype.

    v_world = sum_b w[v,b] * (xpos[bone_b] + R(xquat[bone_b]) @ local[b,v])
    """
    dev, dt = xpos.device, xpos.dtype
    ids = torch.as_tensor(np.asarray(bone_ids, np.int64), device=dev)
    R = quat_to_mat(xquat[:, ids])                        # (F, nbone, 3, 3)
    local = torch.as_tensor(skin.local, dtype=dt, device=dev)
    world = torch.einsum("fbij,bvj->fbvi", R, local) + xpos[:, ids, None]
    w = torch.as_tensor(skin.weights.T, dtype=dt, device=dev)  # (nbone, V)
    return torch.einsum("bv,fbvi->fvi", w, world)
