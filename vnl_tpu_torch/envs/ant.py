"""Ant tracking env (PyTorch counterpart of vnl_tpu/envs/ant.py
AntTracking and make_still_clip), batched over envs.

The debug-scale config of the tracking stack: the reference features are
concatenated into the observation (``info["traj"]`` is its leading part,
for the intention network's traj pathway), the start frame is 0, and the
walker (``mjcf_path``, by default the committed gymnasium ant,
compat.GYM_ANT_XML) runs Newton with 1 iteration and 4 line-search rounds,
the pyramidal cone and RK4 as its file sets: kernel A four times a physics
step, kernel C (Newton's H^-1) once a forward pass, kernel B never.
As in the JAX package, step() scores the PRE-step state: the reward terms
read the state it was given and its frame, the observation the new data
with the old frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vnl_tpu_torch import compat
from vnl_tpu_torch import math as vmath
from vnl_tpu_torch import mjcf
from vnl_tpu_torch.data.preprocess import make_static_clip
from vnl_tpu_torch.data.reference_clip import ReferenceClip
from vnl_tpu_torch.envs.base import PipelineEnv, State
from vnl_tpu_torch.envs.humanoid import _clean, _healthy, _nan_guard
from vnl_tpu_torch.envs.registry import register_environment
from vnl_tpu_torch.physics.model import Model


def make_still_clip(model: Model, clip_length: int = 250,
                    dtype=torch.float32) -> ReferenceClip:
    """The default pose held for clip_length frames, with its com and zero
    velocities (a 'stand still' reference)."""
    return make_static_clip(model, None, clip_length, dtype)


class AntTracking(PipelineEnv):
    def __init__(
        self,
        reference_clip: Optional[ReferenceClip] = None,
        solver: str = "newton",
        iterations: int = 1,
        ls_iterations: int = 4,
        healthy_z_range: Tuple[float, float] = (0.2, 1.0),
        reset_noise_scale: float = 1e-2,
        clip_length: int = 250,
        episode_length: int = 150,
        ref_traj_length: int = 5,
        termination_threshold: float = 0.9,
        body_error_multiplier: float = 1.0,
        physics_steps_per_control_step: int = 5,
        mjcf_path: str = compat.GYM_ANT_XML,
        device="cuda",
        fused_position: bool = True,
        **kwargs,
    ):
        model = mjcf.load_model(
            mjcf_path, overrides={"solver": solver, "iterations": iterations,
                                  "ls_iterations": ls_iterations},
            device=device)
        super().__init__(model, n_frames=kwargs.get(
            "n_frames", physics_steps_per_control_step),
            fused_position=fused_position)
        self._termination_threshold = termination_threshold
        self._healthy_z_range = healthy_z_range
        self._reset_noise_scale = reset_noise_scale
        self._body_error_multiplier = body_error_multiplier
        self._clip_length = clip_length
        self._episode_length = episode_length
        self._ref_traj_length = ref_traj_length
        if reference_clip is None:
            reference_clip = make_still_clip(model, clip_length)
        self._ref_traj = reference_clip._map(lambda x: x.to(model.device))
        if episode_length > clip_length:
            raise ValueError("episode_length cannot be greater than "
                             "clip_length!")

    @property
    def reference_clip(self) -> ReferenceClip:
        return self._ref_traj

    def reset(self, batch: int, generator: Optional[torch.Generator] = None,
              start_frame: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None, **kw) -> State:
        """Resets ``batch`` envs at frame 0 (or ``start_frame``); draws
        nothing.  ``noise`` is accepted for the eval callback's signature
        and must be None."""
        if noise is not None:
            raise ValueError("AntTracking adds no reset noise")
        if start_frame is None:
            start_frame = torch.zeros(batch, dtype=torch.long,
                                      device=self.sys.device)
        return self.reset_to_frame(start_frame)

    def reset_to_frame(self, start_frame: torch.Tensor) -> State:
        m = self.sys
        frame = torch.as_tensor(start_frame, device=m.device).long()
        at = self._ref_traj.at(frame)
        qpos = torch.cat([at.position, at.quaternion, at.joints], -1)
        qvel = torch.cat([at.velocity, at.angular_velocity,
                          at.joints_velocity], -1)
        data = self.pipeline_init(qpos, qvel)
        info = {"cur_frame": frame}
        obs = self._get_obs(data, info)
        info["traj"] = obs[:, :self._traj_size()]
        info["termination_error"] = self._calculate_termination(data, frame)
        zero = torch.zeros(frame.shape[0], device=m.device)
        metrics = {k: zero for k in ("rcom", "rvel", "rtrunk", "rquat",
                                     "ract", "termination_error")}
        return State(data, obs, zero, zero, metrics, info)

    def _traj_size(self) -> int:
        nb = self._ref_traj.body_positions.shape[1]
        return self._ref_traj_length * (nb * 6 + 3 + (self.sys.nq - 7))

    def step(self, state: State, action: torch.Tensor) -> State:
        data = self.pipeline_step(state.pipeline_state, action)
        info = dict(state.info)
        obs = self._get_obs(data, state.info)
        rcom, rvel, rtrunk, rquat, ract, is_healthy = self._calculate_reward(
            state.pipeline_state, state.info["cur_frame"], action)
        total_reward = (0.05 * rcom + 0.01 * rvel + 0.20 * rtrunk
                        + 0.01 * rquat + 0.001 * ract)
        info["termination_error"] = rtrunk
        info["cur_frame"] = info["cur_frame"] + 1
        info["traj"] = obs[:, :self._traj_size()]
        done = torch.maximum(torch.where(rtrunk < 0, 1.0, 0.0),
                             1.0 - is_healthy)
        metrics = dict(state.metrics, rcom=rcom, rvel=rvel, rquat=rquat,
                       ract=ract, rtrunk=rtrunk, termination_error=rtrunk)
        return state.replace(pipeline_state=data, obs=_clean(obs),
                             reward=_clean(total_reward),
                             done=_nan_guard(data, done), metrics=metrics,
                             info=info)

    def _calculate_termination(self, data, frame):
        ref = self._ref_traj.at(frame)
        error_joints = torch.mean(torch.abs(ref.joints - data.qpos[:, 7:]),
                                  -1)
        error_bodies = torch.mean(torch.abs(ref.body_positions - data.xpos),
                                  (-1, -2))
        error = (0.5 * self._body_error_multiplier * error_bodies
                 + 0.5 * error_joints)
        return 1.0 - error / self._termination_threshold

    def _calculate_reward(self, data, frame, action):
        ref = self._ref_traj.at(frame)
        com_ref = (ref.center_of_mass if ref.center_of_mass is not None
                   else ref.position)
        rcom = torch.exp(-100.0 * vmath.norm(data.subtree_com[:, 1] - com_ref))
        qvel_ref = torch.cat([ref.velocity, ref.angular_velocity,
                              ref.joints_velocity], -1)
        rvel = torch.exp(-0.1 * vmath.norm(data.qvel - qvel_ref))
        rtrunk = self._calculate_termination(data, frame)
        rquat = torch.exp(-2.0 * vmath.norm(vmath.bounded_quat_dist(
            data.qpos[:, 3:7], ref.quaternion)))
        ract = 0.01 * -0.015 * torch.sum(action ** 2, -1) / action.shape[-1]
        return (rcom, rvel, rtrunk, rquat, ract,
                _healthy(data.qpos[:, 2], self._healthy_z_range))

    def _get_obs(self, data, info) -> torch.Tensor:
        """Reference features of the window after ``info["cur_frame"]``
        (body positions root-local and global, root position, joints), then
        qpos and qvel."""
        window = self._ref_traj.slice(info["cur_frame"] + 1,
                                      self._ref_traj_length)
        xmat_root = data.xmat[:, 1]

        def to_local(vec):
            return torch.einsum("b...i,bij->b...j", vec, xmat_root)

        diff_bodies = window.body_positions - data.xpos[:, None]
        return torch.cat([
            to_local(diff_bodies).flatten(1), diff_bodies.flatten(1),
            to_local(window.position - data.qpos[:, None, :3]).flatten(1),
            (window.joints - data.qpos[:, None, 7:]).flatten(1),
            data.qpos, data.qvel], -1)


register_environment("ant", lambda **kw: AntTracking(**kw))
