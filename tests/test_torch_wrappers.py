"""The training wrappers of vnl_tpu_torch (Episode, AutoReset, Eval,
wrap_for_training) against vnl_tpu's.

On a toy counter env written on both sides every quantity is a small sum
of float32 numbers, so the comparison is exact: done, truncation, steps,
the restored state and observation, the info (restored or, with
restore_info=False, left running) and the evaluator's tallies.  On the
rodent twin (episode length 3, termination threshold 1.86, so that two of
four envs terminate on the third step and the others are truncated there)
done, truncation, steps and the frame counters are equal and the restored
qpos, observation and reference features compare at the env tests'
rtol/atol 1e-3 (tests/test_torch_rodent_env.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import struct

from vnl_tpu.data.reference_clip import ReferenceClip as JClip
from vnl_tpu.envs import base as jbase
from vnl_tpu.envs import wrappers as jwrap
from vnl_tpu.envs.rodent import RodentTracking as JRodent
from vnl_tpu_torch import compat
from vnl_tpu_torch.envs import State, make_twin_env
from vnl_tpu_torch.envs import wrappers as twrap

import torch_parity as tp

B, STEPS = 4, 9
LIMIT = 4.0          # the toy's episode ends when its counter reaches it


# ---------------------------------------------------------------------------
# the toy counter env, once per package
# ---------------------------------------------------------------------------

@struct.dataclass
class JToyData:
    qpos: jax.Array
    qvel: jax.Array
    act: jax.Array


class JToy(jbase.Env):
    """qpos counts up by 1 + action; done at LIMIT; info counts steps."""

    observation_size, action_size = 2, 1

    def reset(self, rng):
        start = jax.random.randint(rng, (), 0, 3).astype(jnp.float32)
        d = JToyData(qpos=start[None], qvel=jnp.zeros(1), act=jnp.zeros(0))
        zero = jnp.zeros(())
        return jbase.State(d, jnp.stack([start, zero]), zero, zero,
                           {"double": zero},
                           {"count": jnp.zeros((), jnp.int32),
                            "traj": start[None] * 2.0})

    def step(self, state, action):
        d = state.pipeline_state
        qpos = d.qpos + 1.0 + action
        count = state.info["count"] + 1
        reward = 0.25 * qpos[0]
        done = jnp.where(qpos[0] >= LIMIT, 1.0, 0.0)
        info = dict(state.info, count=count, traj=qpos * 2.0)
        return state.replace(
            pipeline_state=d.replace(qpos=qpos, qvel=action),
            obs=jnp.stack([qpos[0], count.astype(jnp.float32)]),
            reward=reward, done=done,
            metrics=dict(state.metrics, double=2.0 * reward), info=info)


@dataclasses.dataclass(frozen=True)
class TToyData:
    qpos: torch.Tensor
    qvel: torch.Tensor
    act: torch.Tensor

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class TToy:
    action_size = 1

    def reset(self, batch, generator=None, start=None):
        d = TToyData(qpos=start[:, None], qvel=torch.zeros(batch, 1),
                     act=torch.zeros(batch, 0))
        zero = torch.zeros(batch)
        return State(d, torch.stack([start, zero], -1), zero, zero,
                     {"double": zero},
                     {"count": torch.zeros(batch, dtype=torch.int32),
                      "traj": start[:, None] * 2.0})

    def step(self, state, action):
        d = state.pipeline_state
        qpos = d.qpos + 1.0 + action
        count = state.info["count"] + 1
        reward = 0.25 * qpos[:, 0]
        done = torch.where(qpos[:, 0] >= LIMIT, 1.0, 0.0)
        info = dict(state.info, count=count, traj=qpos * 2.0)
        return state.replace(
            pipeline_state=d.replace(qpos=qpos, qvel=action),
            obs=torch.stack([qpos[:, 0], count.float()], -1),
            reward=reward, done=done,
            metrics=dict(state.metrics, double=2.0 * reward), info=info)


def _jax_stack(env, episode_length, action_repeat, restore_info, evaluate):
    env = jwrap.EpisodeWrapper(env, episode_length, action_repeat)
    env = jwrap.AutoResetWrapper(jwrap.VmapWrapper(env),
                                 restore_info=restore_info)
    return jwrap.EvalWrapper(env) if evaluate else env


def _torch_stack(env, episode_length, action_repeat, restore_info, evaluate):
    env = twrap.wrap_for_training(env, episode_length, action_repeat,
                                  restore_info)
    return twrap.EvalWrapper(env) if evaluate else env


def _same(got, want, name):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=name)


@pytest.mark.parametrize("action_repeat,restore_info",
                         [(1, True), (1, False), (2, True)])
def test_wrappers_match_on_toy_env(action_repeat, restore_info):
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    starts = np.asarray([jax.random.randint(k, (), 0, 3) for k in keys],
                        np.float32)
    # quarters, so that every sum is exact in float32
    actions = np.random.default_rng(1).integers(
        -2, 3, size=(STEPS, B, 1)).astype(np.float32) / 4.0
    jenv = _jax_stack(JToy(), 3, action_repeat, restore_info, True)
    tenv = _torch_stack(TToy(), 3, action_repeat, restore_info, True)
    js = jenv.reset(keys)
    ts = tenv.reset(B, start=torch.as_tensor(starts))
    seen_done = seen_trunc = 0.0
    for t in range(STEPS):
        js = jenv.step(js, jnp.asarray(actions[t]))
        ts = tenv.step(ts, torch.as_tensor(actions[t]))
        for name in ("obs", "reward", "done"):
            _same(getattr(ts, name), getattr(js, name), f"{name}[{t}]")
        _same(ts.pipeline_state.qpos, js.pipeline_state.qpos, f"qpos[{t}]")
        _same(ts.pipeline_state.qvel, js.pipeline_state.qvel, f"qvel[{t}]")
        for name in ("steps", "truncation", "count", "traj", "first_obs"):
            _same(ts.info[name], js.info[name], f"info.{name}[{t}]")
        _same(ts.metrics["reward"], js.metrics["reward"], "metrics.reward")
        je, te = js.info["eval_metrics"], ts.info["eval_metrics"]
        _same(te.active_episodes, je.active_episodes, f"active[{t}]")
        _same(te.episode_steps, je.episode_steps, f"episode_steps[{t}]")
        for k in je.episode_metrics:
            _same(te.episode_metrics[k], je.episode_metrics[k], f"{k}[{t}]")
        seen_done += float(ts.done.sum())
        seen_trunc += float(ts.info["truncation"].sum())
    assert seen_done > seen_trunc > 0      # terminations and truncations
    assert ("first_info" in ts.info) == restore_info
    if not restore_info:                   # the env's counter ran on
        assert int(ts.info["count"].min()) == STEPS * action_repeat


def test_wrapper_forwards_attributes():
    env = _torch_stack(TToy(), 3, 1, True, True)
    assert env.action_size == 1 and env.episode_length == 3
    assert isinstance(env.unwrapped, TToy)
    with pytest.raises(AttributeError):
        env.no_such_attribute


# ---------------------------------------------------------------------------
# the rodent twin
# ---------------------------------------------------------------------------

def test_wrap_for_training_matches_on_twin():
    threshold, episode_length, steps = 1.86, 3, 5
    with open(f"{tp.ROOT}/configs/env_config.yaml") as f:
        cfg = yaml.safe_load(f)["env"]["env_args"]
    cfg.pop("mjcf_path")
    cfg["termination_threshold"] = threshold
    with np.load(compat.TWIN_CLIP) as z:
        clip = JClip(**{k: jnp.asarray(z[k]) for k in z.files})
    jenv = jwrap.wrap_for_training(
        JRodent(clip, mjcf_path=tp.TWIN_XML, **cfg), episode_length)
    tenv = twrap.wrap_for_training(
        make_twin_env(device="cpu", termination_threshold=threshold,
                      fused_position=False), episode_length)

    keys = jax.random.split(jax.random.PRNGKey(31), B)
    js = jax.jit(jenv.reset)(keys)
    frames, noises = [], []
    for k in keys:
        rng_frame, rng_noise, _, _ = jax.random.split(k, 4)
        frames.append(int(jax.random.randint(rng_frame, (), 0, 235)))
        noises.append(np.asarray(1e-3 * jax.random.normal(rng_noise, (74,))))
    ts = tenv.reset(B, start_frame=torch.tensor(frames),
                    noise=torch.as_tensor(np.stack(noises)))
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(0)
    dones, truncs = [], []
    for t in range(steps):
        action = rng.uniform(-1, 1, size=(B, 30)).astype(np.float32)
        js = jstep(js, jnp.asarray(action))
        ts = tenv.step(ts, torch.as_tensor(action))
        for name in ("steps", "truncation", "cur_frame", "sub_clip_frame"):
            _same(ts.info[name], js.info[name], f"info.{name}[{t}]")
        _same(ts.done, js.done, f"done[{t}]")
        tp.assert_close(ts.pipeline_state.qpos, js.pipeline_state.qpos,
                        1e-3, 1e-3, f"qpos[{t}]")
        tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, f"obs[{t}]")
        tp.assert_close(ts.info["traj"], js.info["traj"], 1e-3, 1e-3,
                        f"traj[{t}]")
        tp.assert_close(ts.reward, js.reward, 1e-5, 1e-5, f"reward[{t}]")
        dones.append(ts.done.numpy())
        truncs.append(ts.info["truncation"].numpy())
    # third step: every episode ends, two by termination, two by truncation
    assert dones[2].tolist() == [1.0] * B
    assert sorted(truncs[2].tolist()) == [0.0, 0.0, 1.0, 1.0]
    # and the restore put every env back on its first frame
    _same(ts.info["first_info"]["cur_frame"], np.asarray(frames), "first")
    assert ts.info["cur_frame"].tolist() == [f + 2 for f in frames]
