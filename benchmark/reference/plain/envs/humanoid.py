"""Humanoid tracking env (PyTorch counterpart of vnl_tpu/envs/humanoid.py
HumanoidTracking), batched over envs, as the port's
``vnl_tpu_torch/envs/humanoid.py`` stood when this configuration joined
the benchmark.

The walker is dm_control's suite humanoid, compiled by the JAX package
with CG, 6 iterations and 6 line-search rounds (``../assets/
humanoid_model.npz``, tools/export_torch_assets.py ``--benchmark-humanoid``);
pyramidal cone and Euler with implicit joint damping are the model's own.
Semantics follow the JAX package, its deviations from the original
reference included: the post-step data pairs with the incremented frame;
the termination error is the mean (not the sum) of the absolute joint and
body errors; a reset draws a start frame and adds no noise.  Without a
clip the env tracks a static clip of the model's first keyframe (qpos0
where it has none)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from benchmark.reference.plain import compat
from benchmark.reference.plain import math as vmath
from benchmark.reference.plain.data.preprocess import make_static_clip
from benchmark.reference.plain.data.reference_clip import ReferenceClip
from benchmark.reference.plain.envs.base import PipelineEnv, State
from benchmark.reference.plain.physics.model import Model

HUMANOID_MODEL = os.path.join(compat.ASSETS, "humanoid_model.npz")


def _nan_guard(data, done):
    """done = 1 where qpos, qvel or qacc is not finite."""
    finite = (torch.isfinite(data.qpos).all(-1)
              & torch.isfinite(data.qvel).all(-1)
              & torch.isfinite(data.qacc).all(-1))
    return torch.where(finite, done, torch.ones_like(done))


def _clean(x):
    """nan and +-inf to 0."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _healthy(z, z_range):
    lo, hi = z_range
    return torch.where((z < lo) | (z > hi), 0.0, 1.0)


class HumanoidTracking(PipelineEnv):
    """Single-clip humanoid tracking over a batch of envs; features come
    from the full body list."""

    def __init__(
        self,
        model: Model,
        reference_clip: Optional[ReferenceClip] = None,
        healthy_z_range: Tuple[float, float] = (1.0, 2.0),
        reset_noise_scale: float = 1e-2,
        clip_length: int = 250,
        episode_length: int = 150,
        ref_traj_length: int = 5,
        termination_threshold: float = 0.9,
        body_error_multiplier: float = 1.0,
        physics_steps_per_control_step: int = 5,
        fused_position: bool = True,
        dtype=torch.float32,
    ):
        super().__init__(model, n_frames=physics_steps_per_control_step,
                         fused_position=fused_position)
        self._termination_threshold = termination_threshold
        self._healthy_z_range = healthy_z_range
        self._reset_noise_scale = reset_noise_scale
        self._body_error_multiplier = body_error_multiplier
        self._clip_length = clip_length
        self._episode_length = episode_length
        self._ref_traj_length = ref_traj_length
        if reference_clip is None:
            qpos = model.key_qpos[1] if model.nkey > 1 else model.qpos0
            reference_clip = make_static_clip(model, qpos, clip_length,
                                              dtype=dtype)
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
        """Resets ``batch`` envs at start frames drawn uniformly from
        [0, clip_length - episode_length - ref_traj_length) unless given;
        no reset noise."""
        if noise is not None:
            raise ValueError("HumanoidTracking adds no reset noise")
        if start_frame is None:
            span = (self._clip_length - self._episode_length
                    - self._ref_traj_length)
            u = torch.rand(batch, generator=generator, device=self.sys.device)
            start_frame = torch.floor(u * span).long()
        return self.reset_to_frame(start_frame)

    def reset_to_frame(self, start_frame: torch.Tensor) -> State:
        ref = self._ref_traj
        frame = torch.as_tensor(start_frame, device=self.sys.device).long()
        at = ref.at(frame)
        qpos = torch.cat([at.position, at.quaternion, at.joints], -1)
        qvel = torch.cat([at.velocity, at.angular_velocity,
                          at.joints_velocity], -1)
        data = self.pipeline_init(qpos, qvel)
        zero = torch.zeros(frame.shape[0], device=self.sys.device)
        info = {"cur_frame": frame, "traj": self._get_traj(data, frame),
                "termination_error": self._calculate_termination(data,
                                                                 frame)}
        metrics = {k: zero for k in ("rcom", "rvel", "rtrunk", "rquat",
                                     "ract", "termination_error")}
        return State(data, self._get_obs(data), zero, zero, metrics, info)

    def step(self, state: State, action: torch.Tensor) -> State:
        data = self.pipeline_step(state.pipeline_state, action)
        info = dict(state.info)
        info["cur_frame"] = info["cur_frame"] + 1
        frame = info["cur_frame"]
        obs = self._get_obs(data)
        traj = self._get_traj(data, frame)
        rcom, rvel, rtrunk, rquat, ract, is_healthy = self._calculate_reward(
            data, frame)
        done = torch.where(rtrunk < 0.5, 1.0, 0.0)
        rcom, rvel, rtrunk, rquat = (x * 0.01 for x in (rcom, rvel, rtrunk,
                                                        rquat))
        ract = ract * 0.0001
        rcom, rvel, rtrunk, rquat, ract = (
            _clean(x) for x in (rcom, rvel, rtrunk, rquat, ract))
        info["termination_error"] = rtrunk
        info["traj"] = traj
        done = _nan_guard(data, torch.maximum(done, 1.0 - is_healthy))
        metrics = dict(state.metrics, rcom=rcom, rvel=rvel, rquat=rquat,
                       ract=ract, rtrunk=rtrunk, termination_error=rtrunk)
        return state.replace(
            pipeline_state=data, obs=_clean(obs),
            reward=_clean(rcom + rvel + rtrunk + rquat + ract), done=done,
            metrics=metrics, info=info)

    def _calculate_termination(self, data, frame):
        """1 - (mean |joint error| + mean |body error|) / 2 / threshold."""
        ref = self._ref_traj.at(frame)
        error_joints = torch.mean(torch.abs(ref.joints - data.qpos[:, 7:]),
                                  -1)
        error_bodies = torch.mean(torch.abs(ref.body_positions - data.xpos),
                                  (-1, -2))
        error = (0.5 * self._body_error_multiplier * error_bodies
                 + 0.5 * error_joints)
        return 1.0 - error / self._termination_threshold

    def _calculate_reward(self, data, frame):
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
        ract = -0.015 * torch.mean(data.qfrc_actuator ** 2, -1)
        return (rcom, rvel, rtrunk, rquat, ract,
                _healthy(data.qpos[:, 2], self._healthy_z_range))

    def _get_obs(self, data) -> torch.Tensor:
        """qpos + qvel."""
        return torch.cat([data.qpos, data.qvel], -1)

    def _get_traj(self, data, cur_frame) -> torch.Tensor:
        """Reference features over the next window: full-body positions
        relative to the body (root-local and global), the root position
        (root-local) and the joints."""
        window = self._ref_traj.slice(cur_frame + 1, self._ref_traj_length)
        xmat_root = data.xmat[:, 1]

        def to_local(vec):          # vec @ xmat_root, per env
            return torch.einsum("b...i,bij->b...j", vec, xmat_root)

        diff_bodies = window.body_positions - data.xpos[:, None]
        return torch.cat([
            to_local(diff_bodies).flatten(1), diff_bodies.flatten(1),
            to_local(window.position - data.qpos[:, None, :3]).flatten(1),
            (window.joints - data.qpos[:, None, 7:]).flatten(1)], -1)


def make_humanoid_env(device="cuda", dtype=torch.float32,
                      **overrides) -> HumanoidTracking:
    """HumanoidTracking on the compiled suite humanoid and its static
    clip, with the env's defaults; ``dtype``: of the model's floating
    tables and of the clip."""
    model = compat.model_from_numpy(HUMANOID_MODEL, device=device,
                                    dtype=dtype)
    return HumanoidTracking(model, dtype=dtype, **overrides)
