"""HumanoidTracking and HumanoidStanding of vnl_tpu_torch against
vnl_tpu's on the committed dm_control humanoid (the JAX envs read the
module constant _HUMANOID_XML, set here with pytest's monkeypatch): reset
with the JAX draws (start frames; the standing task's uniform qpos and
qvel noise), reset_to_frame, then three control steps from the same
state with the same random actions, each package stepping its own state;
cut to one physics step a control step to keep the JAX compile short
(the substep loop is the rodent's tests').  The port runs like with like
the unfused position stage the JAX env runs on the CPU
(``fused_position=False``).  With five substeps the JAX env refines the
carried inverses on the last four; random full-scale actions on the
floating humanoid reach joint accelerations of O(2000), where two
Newton-Schulz steps leave the carried inverse measurably off the exact
one, so the port's fused stage (exact every substep) then ends a control
step beyond these tolerances from the JAX env.

Tolerances, as tests/test_torch_rollout.py holds the rodent: observations
and reference features at rtol = atol = 1e-3, rewards and reward terms at
atol 1e-6 (the terms are O(0.01) after weighting for the tracking task;
the standing task's reward is 5 - 0.1 |a|^2 and its control cost is the
same action in both, so it compares at the same 1e-6 relative scale:
rtol 1e-6), done exactly.  Observation and trajectory sizes equal
JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu.envs import humanoid as jhumanoid
from vnl_tpu_torch import envs as tenvs
from vnl_tpu_torch.envs import State

import torch_parity as tp

B, STEPS = 3, 3
TERMS = ("rcom", "rvel", "rtrunk", "rquat", "ract", "termination_error")


@pytest.fixture(scope="module")
def tracking():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhumanoid, "_HUMANOID_XML", tp.HUMANOID_XML)
        jenv = jhumanoid.HumanoidTracking(physics_steps_per_control_step=1)
    return jenv, tenvs.get_environment("humanoidtracking", device="cpu",
                                       fused_position=False,
                                       physics_steps_per_control_step=1)


@pytest.fixture(scope="module")
def standing():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhumanoid, "_HUMANOID_XML", tp.HUMANOID_XML)
        jenv = jhumanoid.HumanoidStanding(physics_steps_per_control_step=1)
    return jenv, tenvs.get_environment("humanoidstanding", device="cpu",
                                       fused_position=False,
                                       physics_steps_per_control_step=1)


def _to_torch_state(js) -> State:
    info = {k: (torch.as_tensor(np.array(v)).long() if k == "cur_frame"
                else tp.to_torch(v)) for k, v in js.info.items()}
    return State(tp.data_to_torch(js.pipeline_state), tp.to_torch(js.obs),
                 tp.to_torch(js.reward), tp.to_torch(js.done),
                 {k: tp.to_torch(v) for k, v in js.metrics.items()}, info)


def _actions(nu, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(STEPS, B, nu)).astype(np.float32)


@pytest.fixture(scope="module")
def tracking_run(tracking):
    """JAX and torch states: after reset, then after each control step."""
    jenv, tenv = tracking
    keys = jax.random.split(jax.random.PRNGKey(31), B)
    js = jax.jit(jax.vmap(jenv.reset))(keys)
    frames = torch.as_tensor(np.array(js.info["cur_frame"])).long()
    ts = tenv.reset(B, start_frame=frames)
    jstep = jax.jit(jax.vmap(jenv.step))
    out = [(js, ts, jstep)]
    for a in _actions(tenv.action_size, 32):
        js, ts = jstep(js, jnp.asarray(a)), tenv.step(ts, torch.as_tensor(a))
        out.append((js, ts, jstep))
    return out


def test_tracking_reset_matches(tracking, tracking_run):
    jenv, tenv = tracking
    js, ts, _ = tracking_run[0]
    # the start frames the JAX env drew lie in [0, 250 - 150 - 5)
    assert int(js.info["cur_frame"].max()) < 95
    tp.assert_close(ts.pipeline_state.qpos, js.pipeline_state.qpos, 0, 1e-6,
                    "qpos")
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(ts.info["traj"], js.info["traj"], 1e-5, 1e-5, "traj")
    tp.assert_close(ts.info["termination_error"],
                    js.info["termination_error"], 1e-5, 1e-5, "term")
    assert ts.obs.shape == js.obs.shape == (B, 55)
    assert ts.info["traj"].shape == js.info["traj"].shape == (B, 630)


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_tracking_steps_match(tracking_run, step):
    js, ts, _ = tracking_run[step]
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(ts.info["traj"], js.info["traj"], 1e-3, 1e-3, "traj")
    for k in TERMS:
        tp.assert_close(ts.metrics[k], js.metrics[k], 0, 1e-6, k)
    tp.assert_close(ts.reward, js.reward, 0, 1e-6, "reward")
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    np.testing.assert_array_equal(ts.info["cur_frame"].numpy(),
                                  np.asarray(js.info["cur_frame"]))


def test_tracking_step_from_jax_state(tracking, tracking_run):
    """One step from the JAX state itself (converted), as the rodent env
    test does: only this step's differences."""
    jenv, tenv = tracking
    js, _, jstep = tracking_run[0]
    a = _actions(tenv.action_size, 33)[0]
    jn = jstep(js, jnp.asarray(a))
    tn = tenv.step(_to_torch_state(js), torch.as_tensor(a))
    tp.assert_close(tn.obs, jn.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(tn.reward, jn.reward, 0, 1e-6, "reward")


def test_tracking_reset_to_frame(tracking):
    jenv, tenv = tracking
    frames = np.array([0, 40, 94])
    js = jax.jit(jax.vmap(jenv.reset_to_frame))(jnp.asarray(frames))
    ts = tenv.reset_to_frame(torch.as_tensor(frames))
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(ts.info["traj"], js.info["traj"], 1e-5, 1e-5, "traj")
    np.testing.assert_array_equal(ts.info["cur_frame"].numpy(), frames)


@pytest.fixture(scope="module")
def standing_run(standing):
    """The JAX reset's uniform draws (envs/humanoid.py:238-242), handed to
    the torch reset as its noise; then the same control steps."""
    jenv, tenv = standing
    keys = jax.random.split(jax.random.PRNGKey(41), B)
    js = jax.jit(jax.vmap(jenv.reset))(keys)
    m = tenv.sys
    noise = []
    for k in keys:
        _, k1, k2 = jax.random.split(k, 3)
        noise.append(np.concatenate([
            np.asarray(jax.random.uniform(k1, (m.nq,), minval=-1e-2,
                                          maxval=1e-2)),
            np.asarray(jax.random.uniform(k2, (m.nv,), minval=-1e-2,
                                          maxval=1e-2))]))
    ts = tenv.reset(B, noise=torch.as_tensor(np.stack(noise)))
    jstep = jax.jit(jax.vmap(jenv.step))
    out = [(js, ts)]
    for a in _actions(tenv.action_size, 42):
        js, ts = jstep(js, jnp.asarray(a)), tenv.step(ts, torch.as_tensor(a))
        out.append((js, ts))
    return out


def test_standing_reset_matches(standing_run):
    js, ts = standing_run[0]
    tp.assert_close(ts.pipeline_state.qpos, js.pipeline_state.qpos, 0, 1e-6,
                    "qpos")
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(ts.info["com"], js.info["com"], 1e-5, 1e-5, "com")
    assert ts.obs.shape == js.obs.shape == (B, 336)
    assert ts.info["traj"].shape == js.info["traj"].shape == (B, 336)


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_standing_steps_match(standing_run, step):
    js, ts = standing_run[step]
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(ts.reward, js.reward, 1e-6, 0, "reward")
    for k in ("reward_quadctrl", "reward_alive", "x_position",
              "y_position"):
        tp.assert_close(ts.metrics[k], js.metrics[k], 1e-6, 1e-6, k)
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
