"""RodentTracking of vnl_tpu_torch against vnl_tpu's on the rodent twin and
its clip: reset with the same start frame and noise, and step from the
same state (converted from JAX to torch) with the same action.  Checks the
observation (232), the reference features (795), every reward term, the
reward and done, including the post-step-frame termination.

The JAX env runs its unfused position stage on the CPU (the first substep
of a control step inverts the mass matrix exactly, the other four refine
the carried inverses).  The port is compared in both configurations: with
its fused stage (every substep exact) and, like with like, with
``fused_position=False``.

Tolerances: after one control step the port's state differs from the JAX
package's by the solver differences of tests/test_torch_forward.py, so
observations (which hold qvel and actuator forces) and features compare at
rtol/atol 1e-3 and the reward terms, all O(0.01) after weighting, at atol
1e-5, in either configuration: the two exact inverses are different fp32
algorithms (the port's sweep, the JAX package's Schur inverse), and that
difference, not the refinement, sets the floor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vnl_tpu.data.reference_clip import ReferenceClip as JClip
from vnl_tpu.envs.rodent import RodentTracking as JRodent
from vnl_tpu_torch import compat
from vnl_tpu_torch.envs import make_twin_env

import torch_parity as tp

B = 3
TERMS = ("rcom", "rvel", "rtrunk", "rquat", "ract", "rapp",
         "termination_error")


@pytest.fixture(scope="module")
def envs():
    with open(f"{tp.ROOT}/configs/env_config.yaml") as f:
        cfg = yaml.safe_load(f)["env"]["env_args"]
    cfg.pop("mjcf_path")
    with np.load(compat.TWIN_CLIP) as z:
        clip = JClip(**{k: jnp.asarray(z[k]) for k in z.files})
    jenv = JRodent(clip, mjcf_path=tp.TWIN_XML, **cfg)
    return jenv, make_twin_env(device="cpu")


@pytest.fixture(scope="module")
def envs_unfused(envs):
    return envs[0], make_twin_env(device="cpu", fused_position=False)


@pytest.fixture(scope="module")
def reset_pair(envs):
    return _reset_pair(envs)


@pytest.fixture(scope="module")
def reset_pair_unfused(envs_unfused):
    return _reset_pair(envs_unfused)


def _reset_pair(envs):
    """The JAX reset of B envs and the start frames / noise it drew
    (envs/rodent.py:145-176), handed to the torch reset explicitly."""
    jenv, tenv = envs
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    js = jax.jit(jax.vmap(jenv.reset))(keys)
    frames, noises = [], []
    for k in keys:
        rng_frame, rng_noise, _, _ = jax.random.split(k, 4)
        frames.append(int(jax.random.randint(rng_frame, (), 0, 250 - 10 - 5)))
        noises.append(np.asarray(1e-3 * jax.random.normal(rng_noise, (74,))))
    np.testing.assert_array_equal(np.asarray(js.info["cur_frame"]), frames)
    ts = tenv.reset(B, start_frame=torch.tensor(frames),
                    noise=torch.as_tensor(np.stack(noises)))
    return js, ts


def test_reset_matches(reset_pair):
    _check_reset(reset_pair)


def test_reset_unfused_matches(envs_unfused, reset_pair_unfused):
    assert envs_unfused[1].fused_position is False
    _check_reset(reset_pair_unfused)


def _check_reset(pair):
    js, ts = pair
    tp.assert_close(ts.pipeline_state.qpos, js.pipeline_state.qpos, 1e-6,
                    1e-6, "qpos")
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(ts.info["traj"], js.info["traj"], 1e-5, 1e-5, "traj")
    tp.assert_close(ts.info["termination_error"],
                    js.info["termination_error"], 1e-5, 1e-5, "term")
    assert ts.obs.shape == (B, 232) and ts.info["traj"].shape == (B, 795)


def test_step_matches(envs, reset_pair):
    _check_step(envs, reset_pair)


def test_step_unfused_matches(envs_unfused, reset_pair_unfused):
    _check_step(envs_unfused, reset_pair_unfused)


def _check_step(envs, reset_pair):
    jenv, tenv = envs
    js, _ = reset_pair
    # the last env ends its sub-clip on this step: done must be 1
    js = js.replace(info=dict(js.info, sub_clip_frame=js.info[
        "sub_clip_frame"].at[-1].set(9)))
    rng = np.random.default_rng(12)
    action = rng.uniform(-1, 1, size=(B, 30)).astype(np.float32)
    jn = jax.jit(jax.vmap(jenv.step))(js, jnp.asarray(action))
    tn = tenv.step(tp.rodent_state_to_torch(js), torch.as_tensor(action))
    tp.assert_close(tn.obs, jn.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(tn.info["traj"], jn.info["traj"], 1e-3, 1e-3, "traj")
    for k in TERMS:
        tp.assert_close(tn.metrics[k], jn.metrics[k], 1e-5, 1e-5, k)
    tp.assert_close(tn.reward, jn.reward, 1e-5, 1e-5, "reward")
    np.testing.assert_array_equal(tn.done.numpy(), np.asarray(jn.done))
    assert float(tn.done[-1]) == 1.0
    np.testing.assert_array_equal(tn.info["cur_frame"].numpy(),
                                  np.asarray(jn.info["cur_frame"]))
