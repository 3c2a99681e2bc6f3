"""The learner of vnl_tpu_torch as a whole.

(a) From the same parameters, the same batch, the same minibatch order and
the same noise, two minibatch updates of the port (training/train.py
sgd_pass with an explicit ``order``) against two ``update_step``s of
vnl_tpu (value_and_grad + optax.adam): every loss metric at rtol 1e-4, the
updated parameters at rtol 1e-4 / atol 2e-6 (Adam's first steps move each
weight by about the learning rate, 1e-3, whatever its gradient's size).
(b) ``train(...)`` on the rodent twin on the CPU at a tiny size (4 envs,
unroll 4, 2 minibatches, 2 passes, widths 32, 2 training steps, 2 eval
envs, the unfused position stage at two substeps per control step):
metrics finite, every training/* and eval/* name of the JAX trainer
present, parameters moved, normaliser count and env_steps as the batch
arithmetic says, callbacks called, and the same seed gives the same
parameters twice.  The two packages draw different
random numbers, so (b) and (c) are not compared with JAX number for number.
(c) Repeated updates on one fixed batch lower total_loss."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vnl_tpu.training import gradients as jgradients
from vnl_tpu.training import losses as jlosses
from vnl_tpu.training.types import Transition as JTransition
from vnl_tpu_torch import models as tmodels
from vnl_tpu_torch.envs import make_twin_env
from vnl_tpu_torch.training import (TrainingState, Transition,
                                    compute_ppo_intention_loss, gradients,
                                    train)
from vnl_tpu_torch.training.train import sgd_pass

import test_torch_losses as tl

LR = 1e-3
LOSS_NAMES = ("total_loss", "policy_loss", "v_loss", "entropy_loss",
              "kl_loss_intention", "prediction_corr", "explained_variance")


def test_two_minibatch_updates_match():
    rows, steps, num_minibatches = 8, 5, 2
    per = rows // num_minibatches
    policy, value, normalizer = tl.small_weights(11)
    net, params, norm = tl.jax_side(policy, value, normalizer)
    tnet = tl.torch_side(policy, value, normalizer)
    batch = tl.make_batch(12, rows, steps, net, params, norm)
    order = np.random.default_rng(13).permutation(rows)
    keys = [jax.random.PRNGKey(20), jax.random.PRNGKey(21)]

    # vnl_tpu: the body of train.py's apply_minibatch, twice
    optimizer = optax.adam(optax.constant_schedule(LR))
    jupdate = jax.jit(jgradients.gradient_update_fn(
        functools.partial(jlosses.compute_ppo_intention_loss,
                          ppo_network=net, **tl.LOSS_KW),
        optimizer, axis_name=None, has_aux=True))
    jbatch = tl.as_transition(batch, JTransition, jnp.asarray)
    minibatched = jax.tree_util.tree_map(
        lambda x: x[order].reshape((num_minibatches, -1) + x.shape[1:]),
        jbatch)
    opt_state = optimizer.init(params)
    jstats = []
    for i, key in enumerate(keys):
        minibatch = jax.tree_util.tree_map(lambda x: x[i], minibatched)
        (_, stats), params, opt_state = jupdate(
            params, norm, minibatch, key, optimizer_state=opt_state)
        jstats.append(stats)

    # the port: one pass in the same order, fed the noise of each key
    feed = iter([tl.loss_noise(k, per, steps) for k in keys])

    def loss_fn(minibatch):
        latent_noise, entropy_noise = next(feed)
        return compute_ppo_intention_loss(
            tnet, minibatch, latent_noise=latent_noise,
            entropy_noise=entropy_noise, **tl.LOSS_KW)

    tupdate = gradients.gradient_update_fn(
        loss_fn, gradients.make_adam(tnet.parameters(), LR), has_aux=True)
    tstats = sgd_pass(tupdate,
                      tl.as_transition(batch, Transition, torch.as_tensor),
                      num_minibatches, order=torch.as_tensor(order))

    assert len(tstats) == 2
    for i, (got, want) in enumerate(zip(tstats, jstats)):
        for name in LOSS_NAMES:
            np.testing.assert_allclose(
                float(got[name]), float(want[name]), rtol=1e-4,
                err_msg=f"{name} of update {i}")
    for module, tree, start in ((tnet.policy, params.policy, policy),
                                (tnet.value, params.value, value)):
        got = tl.flax_layout(module.named_parameters())
        want = tl.flatten_tree(tree["params"])
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=2e-6,
                                       err_msg=k)
            assert np.abs(w - start[k]).max() > 0.5 * LR, k


# ---------------------------------------------------------------------------

TINY = dict(episode_length=6, num_envs=4, num_eval_envs=2, unroll_length=4,
            batch_size=2, num_minibatches=2, num_updates_per_batch=2,
            normalize_observations=True, learning_rate=1e-3, seed=3)
TRAINING_STEPS = 2
STEPS_PER_TRAINING_STEP = 2 * 4 * 2      # batch * unroll * minibatches


def _tiny_env():
    """The twin with two substeps per control step (one exact inverse, one
    refined): the learner is under test here, not the physics."""
    return make_twin_env(device="cpu", fused_position=False,
                         physics_steps_per_control_step=2)


def _tiny_train(num_evals, **callbacks):
    made = {}

    def factory(*args, **kw):
        net = tmodels.make_intention_ppo_networks(
            *args, intention_latent_size=8, encoder_layer_sizes=(32,),
            decoder_layer_sizes=(32,), value_hidden_layer_sizes=(32,), **kw)
        made["init"] = {k: v.clone() for k, v in net.state_dict().items()}
        made["net"] = net
        return net

    env = _tiny_env()
    out = train(env, num_timesteps=TRAINING_STEPS * STEPS_PER_TRAINING_STEP,
                num_evals=num_evals, network_factory=factory, device="cpu",
                **TINY, **callbacks)
    return out, made


@pytest.fixture(scope="module")
def tiny_run():
    progress, saved = [], []
    out, made = _tiny_train(
        2, progress_fn=lambda step, m: progress.append((step, dict(m))),
        policy_params_fn=lambda *a: saved.append(a))
    return out, made, progress, saved


def test_train_runs_on_the_twin(tiny_run):
    (make_policy, params, metrics), made, progress, saved = tiny_run
    total = TRAINING_STEPS * STEPS_PER_TRAINING_STEP
    # an evaluation before training and one after the single interval
    assert [step for step, _ in progress] == [0, total]
    assert not any(k.startswith("training/") for k in progress[0][1])
    assert progress[1][1] == metrics

    env_metrics = ("rcom", "rvel", "rtrunk", "rquat", "ract", "rapp",
                   "termination_error", "reward")
    names = {"training/sps", "training/walltime", "eval/walltime",
             "eval/avg_episode_length", "eval/epoch_eval_time", "eval/sps"}
    names |= {f"training/{n}" for n in LOSS_NAMES}
    names |= {f"eval/episode_{n}{s}" for n in env_metrics
              for s in ("", "_std")}
    assert names <= set(metrics), names - set(metrics)
    bad = [k for k, v in metrics.items() if not np.isfinite(v)]
    assert not bad, bad
    assert 0 < metrics["eval/avg_episode_length"] <= TINY["episode_length"]

    normalizer, policy_state = params
    assert float(normalizer.count) == total     # one observation per env step
    assert float(normalizer.std.min()) > 0
    (step, made_policy, saved_params), = saved
    assert step == total and made_policy is make_policy
    assert saved_params[1].keys() == policy_state.keys()
    # the networks normalise with the statistics the trainer returned
    torch.testing.assert_close(policy_state["obs_mean"], normalizer.mean)
    torch.testing.assert_close(policy_state["obs_std"], normalizer.std)

    now = made["net"].state_dict()
    for k, v in made["init"].items():
        if k.endswith("weight") or k.endswith("bias"):
            assert not torch.equal(v, now[k]), f"{k} did not move"

    # the returned make_policy acts with the trained networks
    state = _tiny_env().reset(2, generator=torch.Generator().manual_seed(0))
    action, extras = make_policy(deterministic=True)(state.info["traj"],
                                                     state.obs)
    assert action.shape == (2, 30) and extras == {}
    assert bool((action.abs() <= 1).all())


def test_train_is_deterministic_in_its_seed(tiny_run):
    """The same seed gives the same parameters, whether or not an
    evaluation ran before training (the evaluator has its own generator)."""
    (_, (normalizer, policy_state), _), _, _, _ = tiny_run
    (_, (normalizer2, policy_state2), _), _ = _tiny_train(1)
    for k, v in policy_state.items():
        assert torch.equal(v, policy_state2[k]), k
    assert torch.equal(normalizer.mean, normalizer2.mean)


def test_train_rejects_indivisible_batch():
    with pytest.raises(ValueError):
        train(None, num_timesteps=1, episode_length=1, num_envs=3,
              batch_size=2, num_minibatches=2, device="cpu")


def test_training_state_is_a_plain_container():
    state = TrainingState(optimizer_state={}, params={"policy": {},
                                                      "value": {}},
                          normalizer_params=None, env_steps=0)
    assert state.env_steps == 0 and set(state.params) == {"policy", "value"}


# ---------------------------------------------------------------------------

def test_repeated_updates_lower_the_loss():
    policy, value, normalizer = tl.small_weights(31)
    net, params, norm = tl.jax_side(policy, value, normalizer)
    tnet = tl.torch_side(policy, value, normalizer)
    batch = tl.as_transition(tl.make_batch(32, 16, 5, net, params, norm),
                             Transition, torch.as_tensor)
    noise = tl.loss_noise(jax.random.PRNGKey(33), 16, 5)
    update = gradients.gradient_update_fn(
        functools.partial(compute_ppo_intention_loss, tnet,
                          latent_noise=noise[0], entropy_noise=noise[1],
                          **tl.LOSS_KW),
        gradients.make_adam(tnet.parameters(), LR), has_aux=True)
    losses = [float(update(batch)[1]["total_loss"]) for _ in range(30)]
    assert losses[-1] < losses[0] - 0.05, losses
    assert np.isfinite(losses).all()
