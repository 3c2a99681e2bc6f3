"""Rodent mocap-tracking env (PyTorch counterpart of
vnl_tpu/envs/rodent.py RodentTracking), batched over envs.

The model comes compiled (the port has no MJCF compiler yet): the rodent
twin's npz from vnl_tpu_torch/assets by default.  Index spaces, reward
terms, weights and the post-step-frame termination follow the JAX package
exactly, deviations from the original reference included:
- data.xpos lookups use full-model body ids;
- reference-clip body lookups use columns of the walker_body_names axis,
  with hand_L/hand_R aliased to finger_L/finger_R;
- joint features use hinge-order indices (qposadr - 7);
- rtrunk and termination pair the post-step data with the incremented
  frame.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from vnl_tpu_torch import compat
from vnl_tpu_torch import math as vmath
from vnl_tpu_torch.data.reference_clip import ReferenceClip
from vnl_tpu_torch.envs.base import PipelineEnv, State
from vnl_tpu_torch.physics.model import Model

_REF_BODY_ALIASES = {"hand_L": "finger_L", "hand_R": "finger_R"}

# the tracked names of configs/env_config.yaml (the port keeps its own copy)
RODENT_NAMES = dict(
    end_eff_names=["foot_L", "foot_R", "hand_L", "hand_R"],
    appendage_names=["foot_L", "foot_R", "hand_L", "hand_R", "skull"],
    walker_body_names=[
        "torso", "pelvis", "upper_leg_L", "lower_leg_L", "foot_L",
        "upper_leg_R", "lower_leg_R", "foot_R", "skull", "jaw", "scapula_L",
        "upper_arm_L", "lower_arm_L", "finger_L", "scapula_R", "upper_arm_R",
        "lower_arm_R", "finger_R"],
    joint_names=[
        "vertebra_1_extend", "hip_L_supinate", "hip_L_abduct",
        "hip_L_extend", "knee_L", "ankle_L", "toe_L", "hip_R_supinate",
        "hip_R_abduct", "hip_R_extend", "knee_R", "ankle_R", "toe_R",
        "vertebra_C11_extend", "vertebra_cervical_1_bend",
        "vertebra_axis_twist", "atlas", "mandible", "scapula_L_supinate",
        "scapula_L_abduct", "scapula_L_extend", "shoulder_L",
        "shoulder_sup_L", "elbow_L", "wrist_L", "scapula_R_supinate",
        "scapula_R_abduct", "scapula_R_extend", "shoulder_R",
        "shoulder_sup_R", "elbow_R", "wrist_R", "finger_R"],
    center_of_mass="torso")


class RodentTracking(PipelineEnv):
    """Single-clip rodent imitation env over a batch of envs."""

    def __init__(
        self,
        model: Model,
        reference_clip: ReferenceClip,
        end_eff_names: List[str],
        appendage_names: List[str],
        walker_body_names: List[str],
        joint_names: List[str],
        center_of_mass: str,
        healthy_z_range=(0.05, 0.5),
        reset_noise_scale: float = 1e-3,
        clip_length: int = 250,
        sub_clip_length: int = 10,
        min_sub_clip_length: Optional[int] = None,
        ref_traj_length: int = 5,
        termination_threshold: float = 5.0,
        body_error_multiplier: float = 1.0,
        physics_steps_per_control_step: int = 5,
    ):
        super().__init__(model, n_frames=physics_steps_per_control_step)
        b2id = {n: i for i, n in enumerate(model.body_names)}
        dev = model.device
        self._endeff_idxs = model.index([b2id[n] for n in end_eff_names])
        self._app_idxs = model.index([b2id[n] for n in appendage_names])
        self._body_idxs = model.index([b2id[n] for n in walker_body_names])
        ref_cols = {n: i for i, n in enumerate(walker_body_names)}
        self._ref_app_cols = model.index(
            [ref_cols[_REF_BODY_ALIASES.get(n, n)] for n in appendage_names])
        self._ref_com_col = ref_cols[center_of_mass]
        j2qposadr = {n: int(model.jnt_qposadr[model.joint_names.index(n)])
                     for n in joint_names}
        self._joint_cols = model.index([j2qposadr[n] - 7
                                        for n in joint_names])
        self._healthy_z_range = healthy_z_range
        self._reset_noise_scale = reset_noise_scale
        self._termination_threshold = termination_threshold
        self._body_error_multiplier = body_error_multiplier
        self._clip_length = clip_length
        self._sub_clip_length = sub_clip_length
        self._min_sub_clip_length = min_sub_clip_length
        self._ref_traj_length = ref_traj_length
        if sub_clip_length > clip_length:
            raise ValueError("sub_clip_length cannot exceed clip_length!")
        if (min_sub_clip_length is not None
                and not 1 <= min_sub_clip_length <= sub_clip_length):
            raise ValueError("need 1 <= min_sub_clip_length <= "
                             "sub_clip_length")
        nb = reference_clip.body_positions.shape[1]
        if nb == model.nbody:
            bq = reference_clip.body_quaternions
            reference_clip = reference_clip.replace(
                body_positions=reference_clip.body_positions[:, self._body_idxs],
                body_quaternions=None if bq is None else bq[:, self._body_idxs])
        elif nb != len(walker_body_names):
            raise ValueError(f"clip body axis {nb} matches neither walker "
                             f"({len(walker_body_names)}) nor full model "
                             f"({model.nbody})")
        self._ref_clip = reference_clip._map(lambda x: x.to(dev))

    @property
    def reference_clip(self) -> ReferenceClip:
        return self._ref_clip

    # ---- reset / step ----
    def reset(self, batch: int, generator: Optional[torch.Generator] = None,
              start_frame: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None) -> State:
        """Resets ``batch`` envs.  The start frame and the qpos noise are
        drawn from ``generator`` unless given explicitly."""
        m = self.sys
        dev = m.device
        if self._min_sub_clip_length is not None:
            lo = np.log(float(self._min_sub_clip_length))
            hi = np.log(float(self._sub_clip_length))
            u = torch.rand(batch, generator=generator, device=dev)
            sub_len = torch.round(torch.exp(lo + u * (hi - lo))).long()
        else:
            sub_len = torch.full((batch,), self._sub_clip_length,
                                 dtype=torch.long, device=dev)
        if start_frame is None:
            frame_range = torch.clamp(
                self._clip_length - sub_len - self._ref_traj_length, min=1)
            u = torch.rand(batch, generator=generator, device=dev)
            start_frame = torch.floor(u * frame_range).long()
        start_frame = start_frame.to(dev).long()
        if noise is None:
            noise = torch.randn(batch, m.nq, generator=generator, device=dev)
            noise = self._reset_noise_scale * noise
        info = {"cur_frame": start_frame,
                "sub_clip_frame": torch.zeros_like(start_frame),
                "sub_clip_length": sub_len}
        ref = self._ref_clip.at(start_frame)
        qpos = torch.cat([ref.position, ref.quaternion, ref.joints], -1)
        qvel = torch.cat([ref.velocity, ref.angular_velocity,
                          ref.joints_velocity], -1)
        data = self.pipeline_init(qpos + noise.to(qpos.dtype), qvel)
        info["traj"] = self._get_traj(data, start_frame)
        obs = self._get_obs(data, None, info)
        zero = torch.zeros(batch, device=dev)
        metrics = {k: zero for k in ("rcom", "rvel", "rtrunk", "rquat",
                                     "ract", "rapp", "termination_error")}
        info["termination_error"] = self._calculate_termination(
            data, start_frame)
        return State(data, obs, zero, zero, metrics, info)

    def step(self, state: State, action: torch.Tensor) -> State:
        data = self.pipeline_step(state.pipeline_state, action)
        info = dict(state.info)
        info["cur_frame"] = info["cur_frame"] + 1
        info["sub_clip_frame"] = info["sub_clip_frame"] + 1
        frame = info["cur_frame"]

        obs = self._get_obs(data, action, state.info)
        traj = self._get_traj(data, frame)
        rcom, rvel, rtrunk, rquat, ract, rapp, is_healthy = \
            self._calculate_reward(data, frame)
        # weights per the reference envs/rodent.py:193-201
        rcom, rvel, rapp = rcom * 0.01, rvel * 0.01, rapp * 0.01
        rtrunk, rquat, ract = rtrunk * 0.01, rquat * 0.01, ract * 0.0001
        info["termination_error"] = rtrunk
        info["traj"] = traj

        sub_clip_ok = info["sub_clip_frame"] < info["sub_clip_length"]
        done = torch.where(rtrunk < 0, 1.0, 0.0)
        done = torch.maximum(done, 1.0 - is_healthy)
        done = torch.maximum(done, torch.where(sub_clip_ok, 0.0, 1.0))

        def clean(x):
            return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)

        rcom, rvel, rtrunk, rquat, ract, rapp = (
            clean(x) for x in (rcom, rvel, rtrunk, rquat, ract, rapp))
        reward = clean(rcom + rvel + rtrunk + rquat + ract + rapp)
        obs = clean(obs)
        finite = (torch.isfinite(data.qpos).all(-1)
                  & torch.isfinite(data.qvel).all(-1)
                  & torch.isfinite(data.qacc).all(-1)
                  & torch.isfinite(data.act).all(-1))
        done = torch.where(finite, done, 1.0)
        metrics = dict(state.metrics, rcom=rcom, rvel=rvel, rapp=rapp,
                       rquat=rquat, rtrunk=rtrunk, ract=ract,
                       termination_error=rtrunk)
        return state.replace(pipeline_state=data, obs=obs, reward=reward,
                             done=done, metrics=metrics, info=info)

    # ---- reward / termination ----
    def _calculate_termination(self, data, frame):
        """1 - tracking_error / threshold."""
        ref = self._ref_clip.at(frame)
        error_joints = torch.sum(torch.abs(ref.joints - data.qpos[:, 7:]), -1)
        error_bodies = torch.sum(torch.abs(
            ref.body_positions - data.xpos[:, self._body_idxs]), (-1, -2))
        error = (0.5 * self._body_error_multiplier * error_bodies
                 + 0.5 * error_joints)
        return 1.0 - error / self._termination_threshold

    def _calculate_reward(self, data, frame):
        ref = self._ref_clip.at(frame)
        com_ref = ref.body_positions[:, self._ref_com_col]
        rcom = torch.exp(-100.0 * vmath.norm(data.subtree_com[:, 1] - com_ref))
        qvel_ref = torch.cat([ref.velocity, ref.angular_velocity,
                              ref.joints_velocity], -1)
        rvel = torch.exp(-0.1 * vmath.norm(data.qvel - qvel_ref))
        rtrunk = self._calculate_termination(data, frame)
        rquat = torch.exp(-2.0 * vmath.norm(vmath.bounded_quat_dist(
            data.qpos[:, 3:7], ref.quaternion)))
        ract = -0.015 * torch.mean(data.qfrc_actuator ** 2, -1)
        app_c = data.xpos[:, self._app_idxs].flatten(1)
        app_ref = ref.body_positions[:, self._ref_app_cols].flatten(1)
        rapp = torch.exp(-400.0 * vmath.norm(app_c - app_ref))
        z = data.qpos[:, 2]
        lo, hi = self._healthy_z_range
        is_healthy = torch.where((z < lo) | (z > hi), 0.0, 1.0)
        return rcom, rvel, rtrunk, rquat, ract, rapp, is_healthy

    # ---- observations ----
    def _get_obs(self, data, action, info) -> torch.Tensor:
        """qpos + qvel + qfrc_actuator + end-effector positions."""
        return torch.cat([data.qpos, data.qvel, data.qfrc_actuator,
                          data.xpos[:, self._endeff_idxs].flatten(1)], -1)

    def _get_traj(self, data, cur_frame) -> torch.Tensor:
        """Reference features over the upcoming window: appendages + body
        positions (root-local and global) + root position + joints."""
        window = self._ref_clip.slice(cur_frame + 1, self._ref_traj_length)
        xmat_root = data.xmat[:, 1]

        def to_local(vec):          # vec @ xmat_root, per env
            return torch.einsum("b...i,bij->b...j", vec, xmat_root)

        ref_app = window.body_positions[:, :, self._ref_app_cols].flatten(1)
        diff_bodies = (window.body_positions
                       - data.xpos[:, self._body_idxs][:, None])
        diff_root = window.position - data.qpos[:, None, :3]
        rel_joints = (window.joints - data.qpos[:, None, 7:])[
            :, :, self._joint_cols]
        return torch.cat([ref_app, to_local(diff_bodies).flatten(1),
                          diff_bodies.flatten(1),
                          to_local(diff_root).flatten(1),
                          rel_joints.flatten(1)], -1)


def make_twin_env(device="cuda", **overrides) -> RodentTracking:
    """RodentTracking on the rodent twin and its clip (the assets of
    tools/export_torch_assets.py), with the tracked names and settings of
    configs/env_config.yaml."""
    model = compat.model_from_numpy(compat.TWIN_MODEL, device=device)
    clip = compat.clip_from_numpy(compat.TWIN_CLIP, device=device)
    kw = dict(RODENT_NAMES, clip_length=250, sub_clip_length=10,
              ref_traj_length=5, termination_threshold=5.0)
    kw.update(overrides)
    return RodentTracking(model, clip, **kw)
