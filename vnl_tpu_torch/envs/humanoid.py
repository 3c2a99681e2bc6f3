"""Humanoid envs (PyTorch counterparts of vnl_tpu/envs/humanoid.py
HumanoidTracking and HumanoidStanding), batched over envs.

Both compile their walker from an MJCF (``mjcf_path``, by default the
committed dm_control suite humanoid, compat.DM_HUMANOID_XML, or a path
under the package's assets such as ``dm_cmu_humanoid/cmu_humanoid.xml``,
the CMU humanoid of tools/export_cmu_humanoid.py; the JAX envs read a
module constant instead) with the given solver, iterations and
line-search rounds, and run CG, pyramidal cone and Euler as that file
sets them: kernels A and B on every substep.  Semantics follow the JAX
package, its deviations from the original reference included:
- HumanoidTracking pairs the post-step data with the incremented frame;
  its termination error is the mean (not the sum) of the absolute joint
  and body errors; it draws a start frame but adds no reset noise;
- HumanoidStanding carries the subtree com in ``info["com"]`` (the data
  of a restored episode is stale except qpos, qvel, act) and mirrors its
  observation as the ``traj`` pathway of the intention network.
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
from vnl_tpu_torch.envs.registry import register_environment
from vnl_tpu_torch.physics.model import Model


def load_humanoid_model(mjcf_path: str = compat.DM_HUMANOID_XML,
                        solver: str = "cg", iterations: int = 6,
                        ls_iterations: int = 6, device="cuda") -> Model:
    return mjcf.load_model(
        compat.asset_path(mjcf_path),
        overrides={"solver": solver, "iterations": iterations,
                   "ls_iterations": ls_iterations},
        device=device)


def _nan_guard(data, done):
    """done = 1 where qpos, qvel or qacc is not finite."""
    finite = (torch.isfinite(data.qpos).all(-1)
              & torch.isfinite(data.qvel).all(-1)
              & torch.isfinite(data.qacc).all(-1))
    return torch.where(finite, done, torch.ones_like(done))


def _clean(x):
    """nan and +-inf to 0 (a blown-up value would poison the observation
    normaliser's statistics)."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _healthy(z, z_range):
    lo, hi = z_range
    return torch.where((z < lo) | (z > hi), 0.0, 1.0)


class HumanoidTracking(PipelineEnv):
    """Single-clip humanoid tracking over a batch of envs.  Without a
    clip it tracks a built-in static clip of the model's first keyframe
    (qpos0 when there is none).  Features come from the full body list."""

    def __init__(
        self,
        reference_clip: Optional[ReferenceClip] = None,
        solver: str = "cg",
        iterations: int = 6,
        ls_iterations: int = 6,
        healthy_z_range: Tuple[float, float] = (1.0, 2.0),
        reset_noise_scale: float = 1e-2,
        clip_length: int = 250,
        episode_length: int = 150,
        ref_traj_length: int = 5,
        termination_threshold: float = 0.9,
        body_error_multiplier: float = 1.0,
        physics_steps_per_control_step: int = 5,
        mjcf_path: str = compat.DM_HUMANOID_XML,
        device="cuda",
        fused_position: bool = True,
        **kwargs,
    ):
        model = load_humanoid_model(mjcf_path, solver, iterations,
                                    ls_iterations, device)
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
            qpos = model.key_qpos[1] if model.nkey > 1 else model.qpos0
            reference_clip = make_static_clip(model, qpos, clip_length)
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
        [0, clip_length - episode_length - ref_traj_length) unless given.
        The env adds no reset noise (as in the JAX package); ``noise`` is
        accepted for the eval callback's signature and must be None."""
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
        # post-step data with the incremented frame (the JAX package's
        # convention; the pre-step data is stale after an auto-reset)
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


class HumanoidStanding(PipelineEnv):
    """The standing / locomotion task: alive bonus, control cost and an
    optional forward reward, over a batch of envs."""

    def __init__(
        self,
        solver: str = "cg",
        iterations: int = 6,
        ls_iterations: int = 6,
        forward_reward_weight: float = 0.0,
        ctrl_cost_weight: float = 0.1,
        healthy_reward: float = 5.0,
        terminate_when_unhealthy: bool = True,
        healthy_z_range: Tuple[float, float] = (1.0, 2.0),
        reset_noise_scale: float = 1e-2,
        exclude_current_positions_from_observation: bool = True,
        physics_steps_per_control_step: int = 5,
        mjcf_path: str = compat.DM_HUMANOID_XML,
        device="cuda",
        fused_position: bool = True,
        **kwargs,
    ):
        model = load_humanoid_model(mjcf_path, solver, iterations,
                                    ls_iterations, device)
        super().__init__(model, n_frames=kwargs.get(
            "n_frames", physics_steps_per_control_step),
            fused_position=fused_position)
        self._forward_reward_weight = forward_reward_weight
        self._ctrl_cost_weight = ctrl_cost_weight
        self._healthy_reward = healthy_reward
        self._terminate_when_unhealthy = terminate_when_unhealthy
        self._healthy_z_range = healthy_z_range
        self._reset_noise_scale = reset_noise_scale
        self._exclude_pos = exclude_current_positions_from_observation

    def reset(self, batch: int, generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None, **kw) -> State:
        """Resets ``batch`` envs at qpos0 and zero velocity plus uniform
        noise in +-reset_noise_scale: ``noise`` (batch, nq + nv), the
        qpos noise then the qvel noise, or drawn from ``generator``."""
        m = self.sys
        if noise is None:
            s = self._reset_noise_scale
            noise = (2.0 * torch.rand(batch, m.nq + m.nv, generator=generator,
                                      device=m.device) - 1.0) * s
        noise = noise.to(m.device, torch.float32)
        qpos = m.qpos0 + noise[:, :m.nq]
        data = self.pipeline_init(qpos, noise[:, m.nq:].contiguous())
        obs = self._get_obs(data, torch.zeros(batch, m.nu, device=m.device))
        zero = torch.zeros(batch, device=m.device)
        metrics = {k: zero for k in (
            "forward_reward", "reward_linvel", "reward_quadctrl",
            "reward_alive", "x_position", "y_position",
            "distance_from_origin", "x_velocity", "y_velocity")}
        # the com rides in info (AutoResetWrapper restores it): the data of
        # a restored episode holds a stale subtree_com
        info = {"traj": obs, "com": data.subtree_com[:, 1]}
        return State(data, obs, zero, zero, metrics, info)

    def step(self, state: State, action: torch.Tensor) -> State:
        data = self.pipeline_step(state.pipeline_state, action)
        com_before = state.info["com"]
        com_after = data.subtree_com[:, 1]
        velocity = (com_after - com_before) / self.dt
        forward_reward = self._forward_reward_weight * velocity[:, 0]
        is_healthy = _healthy(data.qpos[:, 2], self._healthy_z_range)
        healthy_reward = (torch.full_like(is_healthy, self._healthy_reward)
                          if self._terminate_when_unhealthy
                          else self._healthy_reward * is_healthy)
        ctrl_cost = self._ctrl_cost_weight * torch.sum(action ** 2, -1)
        obs = self._get_obs(data, action)
        reward = forward_reward + healthy_reward - ctrl_cost
        done = (1.0 - is_healthy if self._terminate_when_unhealthy
                else torch.zeros_like(is_healthy))
        done = _nan_guard(data, done)
        metrics = dict(
            state.metrics, forward_reward=forward_reward,
            reward_linvel=forward_reward, reward_quadctrl=-ctrl_cost,
            reward_alive=healthy_reward, x_position=com_after[:, 0],
            y_position=com_after[:, 1],
            distance_from_origin=vmath.norm(com_after),
            x_velocity=velocity[:, 0], y_velocity=velocity[:, 1])
        obs = _clean(obs)
        info = dict(state.info, traj=obs, com=com_after)
        return state.replace(pipeline_state=data, obs=obs,
                             reward=_clean(reward), done=done,
                             metrics=metrics, info=info)

    def _cinert10(self, data) -> torch.Tensor:
        """The 6 x 6 com-frame inertias in MuJoCo's 10-float layout
        [A00, A11, A22, A01, A02, A12, h, m]."""
        c = data.cinert
        A, h, mass = c[..., :3, :3], c[..., :3, 3:], c[..., 3, 3]
        hvec = torch.stack([h[..., 2, 1], h[..., 0, 2], h[..., 1, 0]], -1)
        return torch.cat([A[..., 0, 0:1], A[..., 1, 1:2], A[..., 2, 2:3],
                          A[..., 0, 1:2], A[..., 0, 2:3], A[..., 1, 2:3],
                          hvec, mass[..., None]], -1)

    def _get_obs(self, data, action) -> torch.Tensor:
        """qpos (without x, y) + qvel + cinert + cvel + qfrc_actuator."""
        position = data.qpos[:, 2:] if self._exclude_pos else data.qpos
        return torch.cat([position, data.qvel,
                          self._cinert10(data)[:, 1:].flatten(1),
                          data.cvel[:, 1:].flatten(1), data.qfrc_actuator],
                         -1)


register_environment("humanoidtracking", lambda **kw: HumanoidTracking(**kw))
register_environment("humanoidstanding", lambda **kw: HumanoidStanding(**kw))
