"""STAC qpos -> ReferenceClip preprocessing (PyTorch counterpart of
vnl_tpu/data/preprocess.py).

The JAX package scans its forward kinematics over the frames; the port
runs its batched ``physics.kinematics`` once with the frames as the batch.
Finite differences (quaternion differences for the root) give the
velocities.
"""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference.plain.data.reference_clip import ReferenceClip
from benchmark.reference.plain.physics.forward import make_data
from benchmark.reference.plain.physics.kinematics import kinematics
from benchmark.reference.plain.physics.model import Model

# legacy-pipeline feature body sets of the upstream walker
END_EFFECTOR_BODIES = ("lower_arm_R", "lower_arm_L", "foot_R", "foot_L")
HEAD_BODY = "skull"


def make_static_clip(model: Model, qpos: Optional[torch.Tensor] = None,
                     clip_length: int = 250,
                     dtype=torch.float32) -> ReferenceClip:
    """Holds one pose for clip_length frames (with com and zero
    velocities): the synthetic clips that bring up a tracking env without
    mocap data."""
    qpos = model.qpos0 if qpos is None else torch.as_tensor(qpos)
    qpos = qpos.to(device=model.device, dtype=dtype)
    d = kinematics(model, make_data(model, 1, qpos=qpos[None], dtype=dtype))
    mass = model.body_mass.to(dtype)
    com = (mass[:, None] * d.xipos[0]).sum(0) / mass.sum()
    T = clip_length

    def tile(x):
        return x[None].expand((T,) + x.shape).clone()

    zeros = lambda *s: torch.zeros((T,) + s, dtype=dtype,
                                   device=model.device)
    return ReferenceClip(
        position=tile(qpos[:3]), quaternion=tile(qpos[3:7]),
        joints=tile(qpos[7:]), body_positions=tile(d.xpos[0]),
        body_quaternions=tile(d.xquat[0]), velocity=zeros(3),
        joints_velocity=zeros(model.nq - 7), angular_velocity=zeros(3),
        center_of_mass=tile(com))
