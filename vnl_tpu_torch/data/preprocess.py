"""STAC qpos -> ReferenceClip preprocessing (PyTorch counterpart of
vnl_tpu/data/preprocess.py).

The JAX package scans its forward kinematics over the frames; the port
runs its batched ``physics.kinematics`` once with the frames as the batch.
Finite differences (quaternion differences for the root) give the
velocities.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vnl_tpu_torch import math as vmath
from vnl_tpu_torch.data.io import load_stac_qpos
from vnl_tpu_torch.data.reference_clip import ReferenceClip
from vnl_tpu_torch.physics.forward import make_data
from vnl_tpu_torch.physics.kinematics import kinematics
from vnl_tpu_torch.physics.model import Model

# legacy-pipeline feature body sets of the upstream walker
END_EFFECTOR_BODIES = ("lower_arm_R", "lower_arm_L", "foot_R", "foot_L")
HEAD_BODY = "skull"


def extract_features(m: Model, mocap_qpos: torch.Tensor,
                     legacy_features: bool = False,
                     root_body: int = 1) -> ReferenceClip:
    """Forward kinematics of (..., T, nq) frames -> positions and
    quaternions (velocities not set); every leading dim is batched.

    legacy_features: also the 13-field legacy features: the center of
    mass, and end-effector and appendage positions egocentric to the root
    body ((xpos - xpos_root) @ xmat_root)."""
    lead = mocap_qpos.shape[:-1]
    q = mocap_qpos.reshape(-1, m.nq).to(m.device)
    d = kinematics(m, make_data(m, q.shape[0], qpos=q, dtype=q.dtype))

    def unflat(x):
        return x.reshape(lead + x.shape[1:])

    clip = ReferenceClip(
        position=unflat(q[:, :3]), quaternion=unflat(q[:, 3:7]),
        joints=unflat(q[:, 7:]), body_positions=unflat(d.xpos),
        body_quaternions=unflat(d.xquat))
    if legacy_features and all(b in m.body_names
                               for b in END_EFFECTOR_BODIES + (HEAD_BODY,)):
        bmap = {n: i for i, n in enumerate(m.body_names)}
        app = m.index([bmap[b] for b in END_EFFECTOR_BODIES]
                      + [bmap[HEAD_BODY]])
        mass = m.body_mass.to(q.dtype)
        com = (mass @ d.xipos) / mass.sum()
        rel = torch.einsum("bki,bij->bkj",
                           d.xpos[:, app] - d.xpos[:, root_body, None],
                           d.xmat[:, root_body])
        clip = clip.replace(center_of_mass=unflat(com),
                            end_effectors=unflat(rel[:, :4]),
                            appendages=unflat(rel))
    return clip


def compute_velocity_from_kinematics(qpos_trajectory: torch.Tensor,
                                     dt: float) -> torch.Tensor:
    """(..., T+1, nq) qpos -> (..., T, nv) velocities; the root's angular
    velocity in its local frame."""
    q = qpos_trajectory
    qvel_translation = (q[..., 1:, :3] - q[..., :-1, :3]) / dt
    diff = vmath.normalize(vmath.quat_diff(q[..., :-1, 3:7], q[..., 1:, 3:7]))
    qvel_gyro = vmath.quat_to_axis_angle(diff) / dt
    qvel_joints = (q[..., 1:, 7:] - q[..., :-1, 7:]) / dt
    return torch.cat([qvel_translation, qvel_gyro, qvel_joints], -1)


def with_velocities(clip: ReferenceClip, qpos: torch.Tensor, dt: float,
                    max_qvel: float) -> ReferenceClip:
    """The clip with the finite-difference velocities of its (..., T, nq)
    frames, the last frame repeated so there are T of them, and the joint
    velocities clipped to +-max_qvel."""
    q_pad = torch.cat([qpos, qpos[..., -1:, :]], -2)
    qvel = compute_velocity_from_kinematics(q_pad, dt)
    return clip.replace(
        velocity=qvel[..., :3], angular_velocity=qvel[..., 3:6],
        joints_velocity=torch.clamp(qvel[..., 6:], -max_qvel, max_qvel))


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


def process_clip(stac_path: Optional[str] = None,
                 model: Optional[Model] = None,
                 mocap_qpos: Optional[np.ndarray] = None,
                 mjcf_path: str = "reference/assets/rodent.xml",
                 scale_factor: float = 0.9,
                 start_step: int = 0,
                 clip_length: int = 250,
                 max_qvel: float = 20.0,
                 dt: float = 0.02, device="cuda") -> ReferenceClip:
    """Processes a STAC qpos window into a ReferenceClip on ``device``
    (the model's device when a model is given)."""
    if model is None:
        from vnl_tpu_torch import mjcf
        model = mjcf.load_model(
            mjcf_path, rescale=(scale_factor, scale_factor),
            torque_actuators=True, device=device)
    if mocap_qpos is None:
        mocap_qpos = load_stac_qpos(stac_path)
    q = torch.as_tensor(np.asarray(mocap_qpos, np.float32)[
        start_step:start_step + clip_length], device=model.device)
    return with_velocities(extract_features(model, q), q, dt, max_qvel)
