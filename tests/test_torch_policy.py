"""The intention policy of vnl_tpu_torch against vnl_tpu's, both holding
the 230M keeper's weights (vnl_tpu_torch/assets/keeper_13fcbe84_policy.npz):
distribution parameters, mode, log-prob and the latent posterior for the
same trajectory features, observations and latent noise, at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu import models as jmodels
from vnl_tpu.training import running_statistics as jrs
from vnl_tpu_torch import compat
from vnl_tpu_torch.models import NormalTanhDistribution, make_inference_fn

B = 8


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.fixture(scope="module")
def nets():
    with np.load(compat.KEEPER_POLICY) as z:
        flat = {k: z[k] for k in z.files}
    mean, std = flat.pop("normalizer.mean"), flat.pop("normalizer.std")
    net = jmodels.make_intention_ppo_networks(
        795, 232, 30, intention_latent_size=64,
        encoder_layer_sizes=(256, 128), decoder_layer_sizes=(128, 256),
        preprocess_observations_fn=jrs.normalize)
    norm = jrs.RunningStatisticsState(
        count=jnp.zeros(()), mean=jnp.asarray(mean),
        summed_variance=jnp.zeros(232), std=jnp.asarray(std))
    params = (norm, {"params": _unflatten(flat)})
    tpol = compat.policy_from_numpy(compat.KEEPER_POLICY, device="cpu")
    return net, params, tpol, mean, std


def _inputs(mean, std, seed=0):
    rng = np.random.default_rng(seed)
    traj = (0.05 * rng.normal(size=(B, 795))).astype(np.float32)
    obs = (mean + std * rng.normal(size=(B, 232))).astype(np.float32)
    return traj, obs


def test_network_outputs_match(nets):
    net, params, tpol, mean, std = nets
    traj, obs = _inputs(mean, std)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (B, 64)))
    want = net.policy_network.apply(*params, jnp.asarray(traj),
                                    jnp.asarray(obs), key)
    with torch.no_grad():
        got = tpol(torch.as_tensor(traj), torch.as_tensor(obs),
                   torch.as_tensor(noise))
    for name, g, w in zip(("dist_params", "post_mean", "post_logvar"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_distribution_matches(nets):
    net, params, tpol, mean, std = nets
    jdist = net.parametric_action_distribution
    tdist = NormalTanhDistribution(30)
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(B, 60)).astype(np.float32)
    raw = rng.normal(size=(B, 30)).astype(np.float32)
    noise = rng.normal(size=(B, 30)).astype(np.float32)
    tl, tr = torch.as_tensor(logits), torch.as_tensor(raw)
    pairs = [
        (tdist.mode(tl), jdist.mode(jnp.asarray(logits))),
        (tdist.log_prob(tl, tr), jdist.log_prob(jnp.asarray(logits),
                                                jnp.asarray(raw))),
        (tdist.postprocess(tr), jdist.postprocess(jnp.asarray(raw))),
    ]
    loc, scale = jdist._loc_scale(jnp.asarray(logits))
    pairs.append((tdist.sample_no_postprocessing(tl, torch.as_tensor(noise)),
                  loc + scale * jnp.asarray(noise)))
    key = jax.random.PRNGKey(5)
    pairs.append((tdist.entropy(tl, torch.as_tensor(np.asarray(
        jax.random.normal(key, (B, 30))))),
        jdist.entropy(jnp.asarray(logits), key)))
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_inference_fn_matches(nets):
    """make_inference_fn: the mode policy and the sampling policy's
    extras for the same latent and action noise."""
    net, params, tpol, mean, std = nets
    traj, obs = _inputs(mean, std, seed=5)
    make_policy = jmodels.make_inference_fn(net)
    rng = jax.random.PRNGKey(9)
    _, net_rng = jax.random.split(rng)
    latent = torch.as_tensor(np.asarray(jax.random.normal(net_rng, (B, 64))))
    want, _ = make_policy(params, deterministic=True)(
        jnp.asarray(traj), jnp.asarray(obs), rng)
    tmake = make_inference_fn(tpol)
    got, _ = tmake(deterministic=True)(torch.as_tensor(traj),
                                       torch.as_tensor(obs),
                                       latent_noise=latent)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    draw_rng, net_rng = jax.random.split(rng)
    latent = torch.as_tensor(np.asarray(jax.random.normal(net_rng, (B, 64))))
    act_noise = torch.as_tensor(np.asarray(jax.random.normal(draw_rng,
                                                             (B, 30))))
    uniform = torch.as_tensor(np.asarray(jax.random.uniform(
        draw_rng, (30,), minval=-1.0, maxval=1.0)))
    want, wx = make_policy(params)(jnp.asarray(traj), jnp.asarray(obs), rng)
    got, gx = tmake()(torch.as_tensor(traj), torch.as_tensor(obs),
                      latent_noise=latent, action_noise=act_noise,
                      uniform=uniform)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for k in ("log_prob", "rand_log_prob", "raw_action", "logits"):
        np.testing.assert_allclose(gx[k].numpy(), np.asarray(wx[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
