"""The learner's arithmetic of vnl_tpu_torch against vnl_tpu's: GAE, the
running observation statistics, the value network and the PPO + KL loss
with its gradients, on small networks (trajectory 12, observation 7, action
3, latent 4, hidden widths 16) whose weights both packages load from one
numpy dictionary.

Tolerances: compute_gae on random [T, B] with truncations and terminations
1e-5; running_statistics.update over three batches 1e-5; the value network
1e-5; the seven loss metrics rtol 1e-4; the loss's gradients against
jax.grad rtol 1e-3 / atol 1e-6.  The loss is fed the latent and entropy
noise that the JAX loss draws from its key (vnl_tpu/training/losses.py:99).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu import models as jmodels
from vnl_tpu.training import losses as jlosses
from vnl_tpu.training import running_statistics as jrs
from vnl_tpu.training.types import Transition as JTransition
from vnl_tpu_torch import compat
from vnl_tpu_torch.models import (NormalTanhDistribution,
                                  PPOImitationNetworks)
from vnl_tpu_torch.training import losses as tlosses
from vnl_tpu_torch.training import running_statistics as trs
from vnl_tpu_torch.training.types import Transition as TTransition

from test_torch_policy import _unflatten

TRAJ, OBS, ACT, LATENT, WIDTH = 12, 7, 3, 4, 16
LOSS_KW = dict(entropy_cost=1e-2, discounting=0.95, reward_scaling=2.0,
               gae_lambda=0.9, clipping_epsilon=0.2, kl_weight=1e-2)


def small_weights(seed):
    """(policy, value, normaliser) as flat numpy dictionaries in the Flax
    layout: kernels (in, out) of scale 1/sqrt(in), small biases, LayerNorm
    scales near 1."""
    rng = np.random.default_rng(seed)

    def dense(out, prefix, n_in, n_out):
        out[f"{prefix}.kernel"] = (rng.normal(size=(n_in, n_out))
                                   / np.sqrt(n_in)).astype(np.float32)
        out[f"{prefix}.bias"] = (0.1 * rng.normal(size=n_out)
                                 ).astype(np.float32)

    def norm(out, prefix, n):
        out[f"{prefix}.scale"] = (1.0 + 0.1 * rng.normal(size=n)
                                  ).astype(np.float32)
        out[f"{prefix}.bias"] = (0.1 * rng.normal(size=n)).astype(np.float32)

    policy, value = {}, {}
    dense(policy, "encoder.proj_0", TRAJ, WIDTH)
    norm(policy, "encoder.norm_0", WIDTH)
    dense(policy, "post_mean", WIDTH, LATENT)
    dense(policy, "post_logvar", WIDTH, LATENT)
    dense(policy, "decoder.proj_0", LATENT + OBS, WIDTH)
    norm(policy, "decoder.norm_0", WIDTH)
    dense(policy, "action_head", WIDTH, 2 * ACT)
    # a narrow posterior and a wide action distribution, so that a fresh
    # latent draw moves the log-probs by tenths and the importance ratios
    # fall on both sides of the clip
    policy["post_logvar.kernel"] *= 0.1
    policy["post_logvar.bias"] -= 5.0
    policy["action_head.bias"][ACT:] += 1.0
    dense(value, "hidden_0", OBS, WIDTH)
    dense(value, "hidden_1", WIDTH, 1)
    normalizer = dict(
        count=np.float32(40.0),
        mean=rng.normal(size=OBS).astype(np.float32),
        summed_variance=rng.uniform(20, 60, size=OBS).astype(np.float32),
        std=rng.uniform(0.5, 1.5, size=OBS).astype(np.float32))
    return policy, value, normalizer


def jax_side(policy, value, normalizer):
    """(networks, PPONetworkParams, normaliser state) of vnl_tpu."""
    net = jmodels.make_intention_ppo_networks(
        TRAJ, OBS, ACT, preprocess_observations_fn=jrs.normalize,
        intention_latent_size=LATENT, encoder_layer_sizes=(WIDTH,),
        decoder_layer_sizes=(WIDTH,), value_hidden_layer_sizes=(WIDTH,))
    params = jlosses.PPONetworkParams(
        policy={"params": _unflatten(policy)},
        value={"params": _unflatten(value)})
    norm = jrs.RunningStatisticsState(
        **{k: jnp.asarray(v) for k, v in normalizer.items()})
    return net, params, norm


def torch_side(policy, value, normalizer):
    """The port's networks holding the same weights and normaliser."""
    tpolicy = compat.policy_from_numpy(
        dict(policy, **{"normalizer.mean": normalizer["mean"],
                        "normalizer.std": normalizer["std"]}), device="cpu")
    return PPOImitationNetworks(
        tpolicy, compat.value_from_numpy(value, device="cpu"),
        NormalTanhDistribution(ACT))


def make_batch(seed, rows, steps, net=None, params=None, norm=None):
    """A numpy training batch with [rows, steps] leading dims: random
    observations and features, some terminations and truncations, and
    behaviour log-probs a little off the current policy's."""
    rng = np.random.default_rng(seed)
    shape = (rows, steps)
    f32 = np.float32
    done = rng.random(shape) < 0.25
    truncation = (done & (rng.random(shape) < 0.5)).astype(f32)
    batch = dict(
        observation=rng.normal(size=shape + (OBS,)).astype(f32),
        next_observation=rng.normal(size=shape + (OBS,)).astype(f32),
        action=rng.uniform(-1, 1, size=shape + (ACT,)).astype(f32),
        reward=rng.uniform(0, 1, size=shape).astype(f32),
        discount=(1.0 - done).astype(f32),
        truncation=truncation,
        traj=(0.5 * rng.normal(size=shape + (TRAJ,))).astype(f32),
        raw_action=(0.7 * rng.normal(size=shape + (ACT,))).astype(f32))
    log_prob = -3.0 + rng.normal(size=shape)
    if net is not None:
        # actions the policy itself would take, as in a rollout
        dist = net.parametric_action_distribution
        logits, _, _ = net.policy_network.apply(
            norm, params.policy, jnp.asarray(batch["traj"]),
            jnp.asarray(batch["observation"]), jax.random.PRNGKey(seed))
        raw = dist.sample_no_postprocessing(logits,
                                            jax.random.PRNGKey(seed + 1))
        batch["raw_action"] = np.asarray(raw)
        batch["action"] = np.asarray(dist.postprocess(raw))
        log_prob = (np.asarray(dist.log_prob(logits, raw))
                    + 0.1 * rng.normal(size=shape))
    batch["log_prob"] = log_prob.astype(f32)
    return batch


def as_transition(batch, cls, conv):
    b = {k: conv(np.array(v)) for k, v in batch.items()}
    return cls(
        observation=b["observation"], action=b["action"], reward=b["reward"],
        discount=b["discount"], next_observation=b["next_observation"],
        extras={"policy_extras": {"raw_action": b["raw_action"],
                                  "log_prob": b["log_prob"]},
                "state_extras": {"truncation": b["truncation"],
                                 "traj": b["traj"]}})


def loss_noise(key, rows, steps):
    """The latent and entropy noise the JAX loss draws from ``key``, as
    (steps, rows, ...) tensors."""
    _, net_rng, entropy_rng = jax.random.split(key, 3)
    return (torch.tensor(np.asarray(
                jax.random.normal(net_rng, (steps, rows, LATENT)))),
            torch.tensor(np.asarray(
                jax.random.normal(entropy_rng, (steps, rows, ACT)))))


def flax_layout(named_tensors):
    """Torch parameter (or gradient) names and layouts as Flax's."""
    out = {}
    for key, v in named_tensors:
        name, leaf = key.rsplit(".", 1)
        is_norm = name.split(".")[-1].startswith("norm_")
        v = v.detach().numpy()
        if leaf == "weight":
            out[f"{name}.{'scale' if is_norm else 'kernel'}"] = (
                v if is_norm else v.T)
        else:
            out[f"{name}.bias"] = v
    return out


def flatten_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lambda_,discount", [(0.95, 0.99), (1.0, 0.9)])
def test_compute_gae_matches(lambda_, discount):
    rng = np.random.default_rng(0)
    T, B = 20, 6
    done = rng.random((T, B)) < 0.2
    truncation = (done & (rng.random((T, B)) < 0.5)).astype(np.float32)
    termination = (done & (truncation == 0)).astype(np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    bootstrap = rng.normal(size=B).astype(np.float32)
    assert truncation.sum() > 0 and termination.sum() > 0
    want = jlosses.compute_gae(
        jnp.asarray(truncation), jnp.asarray(termination),
        jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(bootstrap),
        lambda_=lambda_, discount=discount)
    got = tlosses.compute_gae(
        *(torch.as_tensor(x) for x in (truncation, termination, rewards,
                                       values, bootstrap)),
        lambda_=lambda_, discount=discount)
    for name, g, w in zip(("targets", "advantages"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_kl_divergence_matches():
    rng = np.random.default_rng(1)
    mean = rng.normal(size=(5, 4)).astype(np.float32)
    logvar = rng.normal(size=(5, 4)).astype(np.float32)
    want = jlosses.kl_divergence(jnp.asarray(mean), jnp.asarray(logvar))
    got = tlosses.kl_divergence(torch.as_tensor(mean), torch.as_tensor(logvar))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_running_statistics_match():
    """Three batches of [rows, steps, features] folded in one after the
    other; then the normaliser carried across and its inverse."""
    rng = np.random.default_rng(2)
    js = jrs.init_state((OBS,))
    ts = trs.init_state((OBS,), device="cpu")
    for k in range(3):
        batch = (k + rng.normal(size=(4, 5, OBS)) * (1 + k)).astype(np.float32)
        js = jrs.update(js, jnp.asarray(batch))
        ts = trs.update(ts, torch.as_tensor(batch))
        for name in ("count", "mean", "summed_variance", "std"):
            np.testing.assert_allclose(
                getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                rtol=1e-5, atol=1e-5, err_msg=f"{name} after batch {k}")
    assert float(ts.count) == 60.0
    carried = compat.normalizer_from_numpy(
        {k: np.asarray(getattr(js, k))
         for k in ("count", "mean", "summed_variance", "std")}, device="cpu")
    x = rng.normal(size=(3, OBS)).astype(np.float32)
    np.testing.assert_allclose(
        trs.normalize(torch.as_tensor(x), carried.mean, carried.std).numpy(),
        np.asarray(jrs.normalize(jnp.asarray(x), js)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        trs.denormalize(torch.as_tensor(x), carried.mean,
                        carried.std).numpy(),
        np.asarray(jrs.denormalize(jnp.asarray(x), js)), rtol=1e-5,
        atol=1e-5)


def test_value_network_matches():
    policy, value, normalizer = small_weights(3)
    net, params, norm = jax_side(policy, value, normalizer)
    tnet = torch_side(policy, value, normalizer)
    obs = np.random.default_rng(4).normal(size=(5, 6, OBS)).astype(np.float32)
    want = net.value_network.apply(norm, params.value, jnp.asarray(obs))
    with torch.no_grad():
        got = tnet.value_apply(torch.as_tensor(obs))
    assert got.shape == (5, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the weights cross back unchanged
    back = compat.value_to_numpy(tnet.value)
    for k, v in value.items():
        np.testing.assert_array_equal(back[k], v)


def test_ppo_intention_loss_and_gradients_match():
    rows, steps = 6, 5
    policy, value, normalizer = small_weights(5)
    net, params, norm = jax_side(policy, value, normalizer)
    tnet = torch_side(policy, value, normalizer)
    batch = make_batch(6, rows, steps, net, params, norm)
    key = jax.random.PRNGKey(7)

    def jloss(p):
        return jlosses.compute_ppo_intention_loss(
            p, norm, as_transition(batch, JTransition, jnp.asarray), key,
            ppo_network=net, **LOSS_KW)

    (want, wmetrics), wgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)

    latent_noise, entropy_noise = loss_noise(key, rows, steps)
    got, gmetrics = tlosses.compute_ppo_intention_loss(
        tnet, as_transition(batch, TTransition, torch.as_tensor),
        latent_noise=latent_noise, entropy_noise=entropy_noise, **LOSS_KW)
    got.backward()

    assert sorted(gmetrics) == sorted(wmetrics) and len(gmetrics) == 7
    for k in wmetrics:
        np.testing.assert_allclose(float(gmetrics[k]), float(wmetrics[k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    # the surrogate clips somewhere and not everywhere, so both branches
    # of the minimum carry gradient
    for module, tree in ((tnet.policy, wgrads.policy),
                         (tnet.value, wgrads.value)):
        ggrads = flax_layout((n, p.grad) for n, p in
                             module.named_parameters())
        wflat = flatten_tree(tree["params"])
        assert sorted(ggrads) == sorted(wflat)
        for k, w in wflat.items():
            assert np.abs(w).max() > 0, k
            np.testing.assert_allclose(ggrads[k], w, rtol=1e-3, atol=1e-6,
                                       err_msg=k)


def test_loss_draws_its_noise_from_the_generator():
    """Without explicit noise the loss draws from the generator: the same
    seed gives the same loss, another seed another."""
    policy, value, normalizer = small_weights(8)
    tnet = torch_side(policy, value, normalizer)
    data = as_transition(make_batch(9, 4, 3), TTransition, torch.as_tensor)

    def loss(seed):
        with torch.no_grad():
            return float(tlosses.compute_ppo_intention_loss(
                tnet, data, torch.Generator().manual_seed(seed))[0])

    assert loss(0) == loss(0)
    assert loss(0) != loss(1)
