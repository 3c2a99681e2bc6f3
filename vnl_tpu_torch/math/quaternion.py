"""Quaternion algebra, MuJoCo (w, x, y, z) convention (PyTorch counterpart
of vnl_tpu/math/quaternion.py).  Every op broadcasts over leading dims."""

from __future__ import annotations

import math

import torch

_POLE_EPS = 1e-9


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, with broadcasting."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(norm(q, keepdim=True), min=eps)


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product u * v."""
    uw, ux, uy, uz = u.unbind(-1)
    vw, vx, vy, vz = v.unbind(-1)
    return torch.stack([
        uw * vw - ux * vx - uy * vy - uz * vz,
        uw * vx + ux * vw + uy * vz - uz * vy,
        uw * vy - ux * vz + uy * vw + uz * vx,
        uw * vz + ux * vy - uy * vx + uz * vw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    return quat_conj(q) / torch.sum(q * q, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) @ v: v + 2 qw (qv x v) + 2 qv x (qv x v)."""
    qw = q[..., :1]
    qv = q[..., 1:]
    c1 = cross(qv, v)
    return v + 2.0 * (qw * c1 + cross(qv, c1))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion, w >= 0 (branch-free Shepperd)."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    qs = torch.stack([
        1.0 + tr,
        1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
        1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
        1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2],
    ], dim=-1)
    case = torch.argmax(qs, dim=-1)
    d21, d02, d10 = (m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1])
    s01, s02, s12 = (m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1])
    cands = []
    for i, comps in enumerate(((None, d21, d02, d10), (d21, None, s01, s02),
                               (d02, s01, None, s12), (d10, s02, s12, None))):
        s2 = torch.clamp(qs[..., i], min=1e-12)
        q = torch.stack([s2 if c is None else c for c in comps], dim=-1)
        cands.append(q / (2.0 * torch.sqrt(s2))[..., None])
    cands = torch.stack(cands, dim=-2)                       # (..., 4, 4)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)
    return normalize(q)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector, pole-guarded near identity."""
    sin_half = norm(q[..., 1:])
    angle = 2.0 * torch.atan2(sin_half, q[..., 0])
    angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    scale = torch.where(sin_half > _POLE_EPS,
                        angle / torch.clamp(sin_half, min=_POLE_EPS),
                        torch.full_like(angle, 2.0))
    return q[..., 1:] * scale[..., None]


def quat_diff(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_mul(quat_conj(u), v)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """q <- q * exp(0.5 omega dt) (mju_quatIntegrate)."""
    angle = norm(omega) * dt
    dq = axis_angle_to_quat(normalize(omega), angle)
    return normalize(quat_mul(q, dq))


def euler_to_quat(euler: torch.Tensor, seq: str = "xyz") -> torch.Tensor:
    """MJCF euler -> quaternion; lower-case axes are intrinsic."""
    basis = {"x": (1.0, 0.0, 0.0), "y": (0.0, 1.0, 0.0), "z": (0.0, 0.0, 1.0)}
    q = None
    for i, ax in enumerate(seq):
        axis = euler.new_tensor(basis[ax.lower()]).expand(euler[..., :3].shape)
        qi = axis_angle_to_quat(axis, euler[..., i])
        if q is None:
            q = qi
        else:
            q = quat_mul(q, qi) if ax.islower() else quat_mul(qi, q)
    return normalize(q)


def bounded_quat_dist(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.5 arccos(2 <s,t>^2 - 1), shape (..., 1)."""
    source = normalize(source)
    target = normalize(target)
    dist = 2.0 * torch.sum(source * target, dim=-1) ** 2 - 1.0
    dist = torch.clamp(dist, max=1.0)
    return 0.5 * torch.arccos(dist)[..., None]
