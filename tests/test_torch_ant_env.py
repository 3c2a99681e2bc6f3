"""AntTracking of vnl_tpu_torch against vnl_tpu's on the committed gymnasium
ant (the JAX env reads the module constant _ANT_XML, set here with pytest's
monkeypatch): Newton with 1 iteration and 4 line-search rounds, pyramidal
cone, RK4. Reset (frame 0, no draws), reset_to_frame, three control steps
from the same state with the same random actions, each package stepping its
own state, and one step from the JAX state itself. Cut to one physics step
a control step (4 forward passes) to keep the JAX compile short; the
substep loop is the rodent's tests'. The port runs like with like the
unfused position stage the JAX env runs on the CPU
(``fused_position=False``).

Tolerances, as tests/test_torch_rollout.py holds the rodent: observations
and reference features at rtol = atol = 1e-3, rewards at atol 1e-6, done
exactly. The ant's metrics hold its reward terms unweighted (O(1); the
reward weighs them by 0.001 to 0.2), so those compare at atol 1e-5, as
tests/test_torch_rodent_env.py holds the rodent's terms. Observation (504)
and trajectory (475) sizes equal JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu.envs import ant as jant
from vnl_tpu_torch import envs as tenvs
from vnl_tpu_torch.envs import State

import torch_parity as tp

B, STEPS = 3, 3
TERMS = ("rcom", "rvel", "rtrunk", "rquat", "ract", "termination_error")


@pytest.fixture(scope="module")
def envs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jant, "_ANT_XML", tp.ANT_XML)
        jenv = jant.AntTracking(physics_steps_per_control_step=1)
    return jenv, tenvs.get_environment("ant", device="cpu",
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
def run(envs):
    jenv, tenv = envs
    keys = jax.random.split(jax.random.PRNGKey(51), B)
    js = jax.jit(jax.vmap(jenv.reset))(keys)
    ts = tenv.reset(B)
    jstep = jax.jit(jax.vmap(jenv.step))
    out = [(js, ts, jstep)]
    for a in _actions(tenv.action_size, 52):
        js, ts = jstep(js, jnp.asarray(a)), tenv.step(ts, torch.as_tensor(a))
        out.append((js, ts, jstep))
    return out


def test_model_settings(envs):
    from vnl_tpu_torch.physics.model import (ConeType, IntegratorType,
                                             SolverType)
    opt = envs[1].sys.opt
    assert (opt.solver, opt.iterations, opt.ls_iterations, opt.cone,
            opt.integrator) == (SolverType.NEWTON, 1, 4, ConeType.PYRAMIDAL,
                                IntegratorType.RK4)
    assert envs[1].sys.nv == 14


def test_reset_matches(run):
    js, ts, _ = run[0]
    np.testing.assert_array_equal(np.asarray(js.info["cur_frame"]), 0)
    tp.assert_close(ts.pipeline_state.qpos, js.pipeline_state.qpos, 0, 1e-6,
                    "qpos")
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(ts.info["traj"], js.info["traj"], 1e-5, 1e-5, "traj")
    tp.assert_close(ts.info["termination_error"],
                    js.info["termination_error"], 1e-5, 1e-5, "term")
    assert ts.obs.shape == js.obs.shape == (B, 504)
    assert ts.info["traj"].shape == js.info["traj"].shape == (B, 475)


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_steps_match(run, step):
    js, ts, _ = run[step]
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(ts.info["traj"], js.info["traj"], 1e-3, 1e-3, "traj")
    tp.assert_close(ts.reward, js.reward, 0, 1e-6, "reward")
    for k in TERMS:
        tp.assert_close(ts.metrics[k], js.metrics[k], 0, 1e-5, k)
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    np.testing.assert_array_equal(ts.info["cur_frame"].numpy(),
                                  np.asarray(js.info["cur_frame"]))


def test_step_from_jax_state(envs, run):
    jenv, tenv = envs
    js, _, jstep = run[1]
    a = _actions(tenv.action_size, 53)[0]
    jn = jstep(js, jnp.asarray(a))
    tn = tenv.step(_to_torch_state(js), torch.as_tensor(a))
    tp.assert_close(tn.obs, jn.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(tn.reward, jn.reward, 0, 1e-6, "reward")
    np.testing.assert_array_equal(tn.done.numpy(), np.asarray(jn.done))


def test_reset_to_frame(envs):
    jenv, tenv = envs
    frames = np.array([0, 7, 120])
    js = jax.jit(jax.vmap(jenv.reset_to_frame))(jnp.asarray(frames))
    ts = tenv.reset_to_frame(torch.as_tensor(frames))
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(ts.info["traj"], js.info["traj"], 1e-5, 1e-5, "traj")
    np.testing.assert_array_equal(ts.info["cur_frame"].numpy(), frames)


def test_still_clip_matches():
    """make_still_clip: the default pose and its com, every frame."""
    from vnl_tpu_torch.envs import make_still_clip
    jm = tp.jax_scene(tp.ANT_XML)
    want = jant.make_still_clip(jm, clip_length=4)
    got = make_still_clip(tp.torch_model(jm), clip_length=4)
    for k in ("position", "quaternion", "joints", "body_positions",
              "center_of_mass", "velocity"):
        tp.assert_close(getattr(got, k), getattr(want, k), 1e-6, 1e-6, k)
