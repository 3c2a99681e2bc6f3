"""Spatial (6D) vector algebra, [angular, linear] ordering (PyTorch
counterpart of vnl_tpu/math/spatial.py).  All ops broadcast over leading
dims."""

from __future__ import annotations

import torch

from benchmark.reference.plain.math.quaternion import cross


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    vw, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat([cross(vw, mw), cross(vw, ml) + cross(vl, mw)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    vw, vl = v[..., :3], v[..., 3:]
    fw, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(vw, fw) + cross(vl, fl), cross(vw, fl)], dim=-1)


def transform_motion(m: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    w, v = m[..., :3], m[..., 3:]
    return torch.cat([w, v - cross(offset, w)], dim=-1)


def transform_force(f: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    t, fl = f[..., :3], f[..., 3:]
    return torch.cat([t - cross(offset, fl), fl], dim=-1)


def inertia_at_point(mass, inertia_diag, rot, com, point) -> torch.Tensor:
    """(..., 6, 6) spatial inertia about ``point`` (world frame)."""
    ic = rot @ (inertia_diag[..., :, None] * rot.transpose(-1, -2))
    cx = skew(com - point)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=ic.dtype, device=ic.device)
    top = torch.cat([ic + m * (cx @ cx.transpose(-1, -2)), m * cx], dim=-1)
    bot = torch.cat([m * cx.transpose(-1, -2), m * eye.expand_as(ic)], dim=-1)
    return torch.cat([top, bot], dim=-2)
