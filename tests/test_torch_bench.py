"""The port's bench (vnl_tpu_torch/bench.py) on the CPU.

``run_stepping`` against the JAX bench's stepping mode: the same reset
state of vnl_tpu's RodentTracking on the rodent twin, converted to torch,
and the same seeded numpy actions, stepped three control steps by
``jax.vmap(env.step)`` and by ``run_stepping`` (no policy, no auto-reset).
The last env ends its sub-clip on the first step: both go on stepping it,
done stays 1.  The port runs its unfused position stage, like with like
with the JAX env on the CPU (tests/test_torch_rodent_env.py).

Tolerances, those of tests/test_torch_rodent_env.py: qpos and qvel (the
observation's first 147 entries) at rtol/atol 1e-3, the reward at atol
1e-5, done exactly.  After three control steps the two states differ by
the solver differences of tests/test_torch_forward.py, three times over.

Then the keys of both modes' JSON lines, and the command line's exit
without a CUDA device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vnl_tpu.data.reference_clip import ReferenceClip as JClip
from vnl_tpu.envs.rodent import RodentTracking as JRodent
from vnl_tpu_torch import bench, compat
from vnl_tpu_torch import models as tmodels
from vnl_tpu_torch.envs import make_twin_env

import torch_parity as tp

B, STEPS = 4, 3
JAX_LINE_KEYS = ("metric", "value", "unit", "mode", "median", "samples")


@pytest.fixture(scope="module")
def stepped():
    with open(f"{tp.ROOT}/configs/env_config.yaml") as f:
        cfg = yaml.safe_load(f)["env"]["env_args"]
    cfg.pop("mjcf_path")
    with np.load(compat.TWIN_CLIP) as z:
        clip = JClip(**{k: jnp.asarray(z[k]) for k in z.files})
    jenv = JRodent(clip, mjcf_path=tp.TWIN_XML, **cfg)
    tenv = make_twin_env(device="cpu", fused_position=False)
    js = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(5), B))
    # the last env ends its sub-clip on the first step
    js = js.replace(info=dict(js.info, sub_clip_frame=js.info[
        "sub_clip_frame"].at[-1].set(9)))
    start = tp.rodent_state_to_torch(js)
    actions = (0.3 * np.random.default_rng(7).normal(
        size=(STEPS, B, tenv.action_size))).astype(np.float32)
    step = jax.jit(jax.vmap(jenv.step))
    jstates = []
    for a in actions:
        js = step(js, jnp.asarray(a))
        jstates.append(js)
    out = bench.run_stepping(device="cpu", batch=B, n_steps=STEPS,
                             samples=1, warmup=0, env=tenv, state=start,
                             actions=torch.as_tensor(actions))
    return jstates, out, start


def test_stepping_matches_jax(stepped):
    jstates, out, _ = stepped
    js, ts = jstates[-1], out["state"]
    d = ts.pipeline_state
    tp.assert_close(d.qpos, js.pipeline_state.qpos, 1e-3, 1e-3, "qpos")
    tp.assert_close(d.qvel, js.pipeline_state.qvel, 1e-3, 1e-3, "qvel")
    tp.assert_close(ts.reward, js.reward, 1e-5, 1e-5, "reward")
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    np.testing.assert_array_equal(ts.info["cur_frame"].numpy(),
                                  np.asarray(js.info["cur_frame"]))


def test_stepping_keeps_stepping_a_terminated_env(stepped):
    """No auto-reset, as jax.vmap(env.step): the env done on the first
    step moves on with the JAX env's and its frame counts on."""
    jstates, out, start = stepped
    assert float(jstates[0].done[-1]) == 1.0
    ts = out["state"]
    assert float(ts.done[-1]) == 1.0
    assert int(ts.info["cur_frame"][-1]) == \
        int(start.info["cur_frame"][-1]) + STEPS
    first = np.asarray(jstates[0].pipeline_state.qpos[-1])
    assert np.abs(ts.pipeline_state.qpos[-1].numpy() - first).max() > 1e-4
    tp.assert_close(ts.pipeline_state.qpos[-1],
                    jstates[-1].pipeline_state.qpos[-1], 1e-3, 1e-3,
                    "qpos of the terminated env")


def test_stepping_line(stepped):
    """The JAX bench's keys, the samples and the launches per sample (no
    kernel launches on the CPU)."""
    _, out, _ = stepped
    assert all(k in out for k in JAX_LINE_KEYS)
    assert (out["metric"], out["unit"], out["mode"], out["samples"]) == \
        ("rodent_imitation_env_steps_per_s", "env-steps/s", "stepping", 1)
    assert out["value"] == out["median"] == out["sample_env_steps_per_s"][0]
    assert out["envs"] == B and out["steps_per_sample"] == STEPS
    assert out["launches_per_sample"] == [
        {"position": 0, "cg": 0, "sweep": 0}]
    assert out["value"] == pytest.approx(B * STEPS / out["sample_s"][0])


def test_stepping_draws_its_own_reset_and_actions():
    """Without a state and actions: a seeded reset and 0.3 N(0, 1)
    actions; the same seed gives the same states."""
    env = make_twin_env(device="cpu", fused_position=False,
                        physics_steps_per_control_step=1)
    kw = dict(device="cpu", batch=2, n_steps=2, samples=2, warmup=1,
              env=env)
    a, b = bench.run_stepping(seed=3, **kw), bench.run_stepping(seed=3, **kw)
    assert a["samples"] == 2 and len(a["launches_per_sample"]) == 2
    assert torch.equal(a["state"].pipeline_state.qpos,
                       b["state"].pipeline_state.qpos)
    assert bool(torch.isfinite(a["state"].pipeline_state.qvel).all())


def test_summary_is_the_jax_line():
    """bench.py:204-209: the best sample, the median of the last half."""
    s = bench.summary("train", [1.0, 5.0, 3.0, 4.0, 2.0])
    assert s == {"metric": "rodent_imitation_env_steps_per_s", "value": 5.0,
                 "unit": "env-steps/s", "mode": "train", "median": 3.0,
                 "samples": 5}


def test_train_line():
    """The train mode at narrow widths: both intervals' training/sps are
    the samples, the second is reported."""
    def factory(*args, **kw):
        return tmodels.make_intention_ppo_networks(
            *args, intention_latent_size=8, encoder_layer_sizes=(32,),
            decoder_layer_sizes=(32,), value_hidden_layer_sizes=(32,), **kw)

    env = make_twin_env(device="cpu", fused_position=False,
                        physics_steps_per_control_step=2)
    out = bench.run(False, 1, device="cpu", env=env, episode_length=6,
                    num_envs=4, num_eval_envs=2, unroll_length=4,
                    batch_size=2, num_minibatches=2, num_updates_per_batch=2,
                    network_factory=factory)
    assert all(k in out for k in JAX_LINE_KEYS)
    assert (out["mode"], out["samples"]) == ("train", 2)
    assert out["median"] == out["training_env_steps_per_s"] == \
        out["sample_env_steps_per_s"][1]
    assert out["env_steps"] == 2 * 2 * 4 * 2
    assert out["launches"] == {"position": 0, "cg": 0, "sweep": 0}


def test_command_line_needs_a_cuda_device(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main(["--mode", "stepping"]) == 1
    assert capsys.readouterr().out == ""
