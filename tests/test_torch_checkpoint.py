"""Checkpoints of vnl_tpu_torch: the port's own round trip, the carry-over
of a JAX TrainingState, and a resumed training run.

(a) save / save_async / restore of a TrainingState after real Adam steps
give back every tensor bit for bit, and latest_checkpoint finds the
highest step.
(b) A JAX TrainingState after one optax.adam update at narrow widths
(tests/test_torch_losses.py's networks), flattened by
tools/export_torch_assets.py (from the object and from a .msgpack file),
restores in the port with equal parameters and Adam moments and Adam's
step = optax's count; one further update with the same gradients on both
sides agrees within 1e-6.
(c) A tiny CPU run trained to N = 32 env steps with ``checkpoint_dir``,
resumed with ``restore_checkpoint_path`` to 64: the resumed run starts at
N (its first evaluation is reported at 0 and its interval ends at 64, as
num_timesteps is absolute), Adam's step count goes on from 8 to 16, and
the restored parameters are the first run's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from tools import export_torch_assets as exporter
from vnl_tpu.training.train import TrainingState as JTrainingState
from vnl_tpu_torch import compat
from vnl_tpu_torch import models as tmodels
from vnl_tpu_torch.envs import make_twin_env
from vnl_tpu_torch.training import checkpoint, gradients, train
from vnl_tpu_torch.training.train import TrainingState, load_training_state

import test_torch_losses as tl

LR = 1e-3


def _grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)),
        tree)


def _port_state(seed=51, steps=3):
    """The port's networks and Adam after ``steps`` updates with random
    gradients, and its TrainingState."""
    policy, value, normalizer = tl.small_weights(seed)
    tnet = tl.torch_side(policy, value, normalizer)
    opt = gradients.make_adam(tnet.parameters(), LR)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in tnet.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    named = dict(tnet.named_parameters())
    norm = compat.normalizer_from_numpy(normalizer, device="cpu")
    ts = TrainingState(
        optimizer_state=gradients.adam_state(opt, named),
        params={"policy": tnet.policy.state_dict(),
                "value": tnet.value.state_dict()},
        normalizer_params=norm, env_steps=12345)
    return tnet, opt, ts


def _assert_states_equal(got, want):
    assert got.env_steps == want.env_steps
    assert got.optimizer_state["step"] == want.optimizer_state["step"]
    for k in ("count", "mean", "summed_variance", "std"):
        assert torch.equal(getattr(got.normalizer_params, k),
                           getattr(want.normalizer_params, k)), k
    for net in ("policy", "value"):
        want_params = {k: v for k, v in want.params[net].items()
                       if not k.startswith("obs_")}
        assert got.params[net].keys() == want_params.keys()
        for k, v in want_params.items():
            assert torch.equal(got.params[net][k], v), (net, k)
    for m in ("exp_avg", "exp_avg_sq"):
        assert got.optimizer_state[m].keys() == want.optimizer_state[m].keys()
        for k, v in want.optimizer_state[m].items():
            assert torch.equal(got.optimizer_state[m][k], v), (m, k)


def test_save_restore_round_trip(tmp_path):
    _, _, ts = _port_state()
    assert ts.optimizer_state["step"] == 3
    path = checkpoint.save(str(tmp_path), 100, ts)
    assert path.endswith("100.npz")
    _assert_states_equal(checkpoint.restore(path, device="cpu"), ts)

    checkpoint.save_async(str(tmp_path), 2000, ts)
    checkpoint.save_async(str(tmp_path), 300, ts)   # joins the first
    checkpoint.wait_for_pending_saves()
    assert checkpoint.latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / "2000.npz")
    _assert_states_equal(
        checkpoint.restore(str(tmp_path / "300.npz"), device="cpu"), ts)
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None


def test_save_async_copies_before_returning(tmp_path):
    """The state's tensors are live: an in-place update right after
    save_async returns must not reach the file."""
    tnet, _, ts = _port_state()
    before = ts.params["value"]["hidden_0.weight"].clone()
    checkpoint.save_async(str(tmp_path), 7, ts)
    with torch.no_grad():
        tnet.value.hidden_0.weight.add_(1.0)
    checkpoint.wait_for_pending_saves()
    got = checkpoint.restore(str(tmp_path / "7.npz"), device="cpu")
    assert torch.equal(got.params["value"]["hidden_0.weight"], before)


def test_params_file_loads_as_the_policy(tmp_path):
    tnet, _, ts = _port_state()
    path = checkpoint.save_params(str(tmp_path / "finished"),
                                  (ts.normalizer_params,
                                   tnet.policy.state_dict()))
    assert path.endswith("finished.npz")
    policy = checkpoint.load_params(str(tmp_path / "finished"), device="cpu")
    for k, v in tnet.policy.state_dict().items():
        assert torch.equal(policy.state_dict()[k], v), k


@pytest.fixture(scope="module")
def jax_state():
    """A JAX TrainingState after one optax.adam update."""
    policy, value, normalizer = tl.small_weights(61)
    _, params, norm = tl.jax_side(policy, value, normalizer)
    opt = optax.adam(optax.constant_schedule(LR))
    opt_state = opt.init(params)
    updates, opt_state = opt.update(_grads_like(params, 62), opt_state,
                                    params)
    params = optax.apply_updates(params, updates)
    state = JTrainingState(optimizer_state=opt_state, params=params,
                           normalizer_params=norm,
                           env_steps=jnp.asarray(4096, jnp.int32))
    return state, opt, (policy, value, normalizer)


def test_jax_state_flattens_alike(jax_state, tmp_path):
    state, _, _ = jax_state
    flat = exporter.training_state_to_numpy(state)
    path = tmp_path / "state.msgpack"
    path.write_bytes(serialization.to_bytes(state))
    from_file = exporter.training_state_to_numpy(
        exporter.read_jax_checkpoint(str(path)))
    assert flat.keys() == from_file.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(from_file[k], v, err_msg=k)
    assert int(flat["optimizer.count"]) == 1 and int(flat["env_steps"]) == 4096


def test_jax_state_resumes_in_the_port(jax_state, tmp_path):
    state, opt, (policy, value, normalizer) = jax_state
    path = tmp_path / "4096.npz"
    with open(path, "wb") as f:
        np.savez(f, **exporter.training_state_to_numpy(state))
    ts = checkpoint.restore(str(path), device="cpu")
    assert ts.env_steps == 4096 and ts.optimizer_state["step"] == 1

    tnet = tl.torch_side(*tl.small_weights(99))   # other weights, replaced
    topt = gradients.make_adam(tnet.parameters(), LR)
    load_training_state(tnet, topt, ts)
    adam = state.optimizer_state[0]
    index = {p: i for i, p in enumerate(topt.params)}
    for net, module in (("policy", tnet.policy), ("value", tnet.value)):
        got = tl.flax_layout(module.named_parameters())
        want = tl.flatten_tree(getattr(state.params, net)["params"])
        assert sorted(got) == sorted(want)
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            got_m = tl.flax_layout(
                (n, getattr(topt, key)[index[p]])
                for n, p in module.named_parameters())
            want_m = tl.flatten_tree(
                getattr(getattr(adam, moment), net)["params"])
            for k, w in want_m.items():
                np.testing.assert_array_equal(got_m[k], w, err_msg=k)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert float(topt.count) == 1.0

    # one further update with the same gradients on both sides
    grads = _grads_like(state.params, 63)
    updates, _ = opt.update(grads, state.optimizer_state, state.params)
    params = optax.apply_updates(state.params, updates)
    for net, module in (("policy", tnet.policy), ("value", tnet.value)):
        g = tl.flatten_tree(getattr(grads, net)["params"])
        for name, p in module.named_parameters():
            key = compat.flax_key(name)
            p.grad = compat.from_flax(key, g[key])
    topt.step()
    for net, module in (("policy", tnet.policy), ("value", tnet.value)):
        got = tl.flax_layout(module.named_parameters())
        want = tl.flatten_tree(getattr(params, net)["params"])
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6,
                                       err_msg=k)


TINY = dict(episode_length=6, num_envs=4, num_eval_envs=2, unroll_length=4,
            batch_size=2, num_minibatches=2, num_updates_per_batch=2,
            normalize_observations=True, learning_rate=1e-3, seed=3)
PER_STEP = 2 * 4 * 2                    # batch * unroll * minibatches
UPDATES_PER_STEP = 2 * 2                # passes * minibatches


def _tiny_train(num_timesteps, num_evals, **kw):
    env = make_twin_env(device="cpu", fused_position=False,
                        physics_steps_per_control_step=2)
    factory = functools.partial(
        tmodels.make_intention_ppo_networks, intention_latent_size=8,
        encoder_layer_sizes=(32,), decoder_layer_sizes=(32,),
        value_hidden_layer_sizes=(32,))
    seen = []
    out = train(env, num_timesteps=num_timesteps, num_evals=num_evals,
                network_factory=factory, device="cpu",
                progress_fn=lambda step, m: seen.append(step), **TINY, **kw)
    return out, seen


def test_resume_continues_training(tmp_path):
    first, second = str(tmp_path / "first"), str(tmp_path / "second")
    (_, (norm1, policy1), _), seen1 = _tiny_train(
        2 * PER_STEP, 2, checkpoint_dir=first)
    assert seen1 == [0, 2 * PER_STEP]
    path = checkpoint.latest_checkpoint(first)
    assert path.endswith(f"{2 * PER_STEP}.npz")
    saved = checkpoint.restore(path, device="cpu")
    assert saved.env_steps == 2 * PER_STEP
    assert saved.optimizer_state["step"] == 2 * UPDATES_PER_STEP
    assert torch.equal(saved.normalizer_params.mean, norm1.mean)
    for k, v in saved.params["policy"].items():
        assert torch.equal(v, policy1[k]), k

    (_, (norm2, policy2), _), seen2 = _tiny_train(
        4 * PER_STEP, 3, checkpoint_dir=second,
        restore_checkpoint_path=path)
    assert seen2 == [0, 4 * PER_STEP]
    assert float(norm2.count) == 4 * PER_STEP   # went on from the first
    resumed = checkpoint.restore(checkpoint.latest_checkpoint(second),
                                 device="cpu")
    assert resumed.env_steps == 4 * PER_STEP
    assert resumed.optimizer_state["step"] == 4 * UPDATES_PER_STEP
    assert not torch.equal(policy2["encoder.proj_0.weight"],
                           policy1["encoder.proj_0.weight"])
