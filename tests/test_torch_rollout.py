"""The slice end to end: generate_unroll of vnl_tpu_torch against vnl_tpu
on the rodent twin, B = 2 envs for 3 control steps (15 physics substeps),
driven by the keeper's mode policy with the same latent noise fed to both.

Tolerances: each step adds the solver differences of
tests/test_torch_forward.py, and the policy feeds the state back into the
actions, so after 3 steps observations compare at rtol/atol 1e-2 and the
rewards (O(0.01)) at atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vnl_tpu import models as jmodels
from vnl_tpu.envs.wrappers import VmapWrapper
from vnl_tpu.training import acting as jacting
from vnl_tpu.training import running_statistics as jrs
from vnl_tpu_torch import compat
from vnl_tpu_torch.models import make_inference_fn
from vnl_tpu_torch.training import generate_unroll

from test_torch_policy import _unflatten
from test_torch_rodent_env import envs  # noqa: F401 (fixture)

B, STEPS = 2, 3


def test_generate_unroll_matches(envs):
    jenv, tenv = envs
    with np.load(compat.KEEPER_POLICY) as z:
        flat = {k: z[k] for k in z.files}
    mean, std = flat.pop("normalizer.mean"), flat.pop("normalizer.std")
    net = jmodels.make_intention_ppo_networks(
        795, 232, 30, intention_latent_size=64,
        encoder_layer_sizes=(256, 128), decoder_layer_sizes=(128, 256),
        preprocess_observations_fn=jrs.normalize)
    params = (jrs.RunningStatisticsState(
        count=jnp.zeros(()), mean=jnp.asarray(mean),
        summed_variance=jnp.zeros(232), std=jnp.asarray(std)),
        {"params": _unflatten(flat)})
    policy = jmodels.make_inference_fn(net)(params, deterministic=True)

    keys = jax.random.split(jax.random.PRNGKey(21), B)
    wenv = VmapWrapper(jenv)
    js = jax.jit(wenv.reset)(keys)
    key = jax.random.PRNGKey(22)
    jfinal, jroll = jax.jit(lambda s, k: jacting.generate_unroll(
        wenv, s, policy, k, STEPS))(js, key)

    # the latent noise the JAX mode policy draws at each step
    # (acting.py:50 step key -> ppo_networks.py:41 net key)
    noises, k = [], key
    for _ in range(STEPS):
        step_key, k = jax.random.split(k)
        _, net_rng = jax.random.split(step_key)
        noises.append(torch.as_tensor(np.asarray(
            jax.random.normal(net_rng, (B, 64)))))

    frames, resets = [], []
    for kk in keys:
        rng_frame, rng_noise, _, _ = jax.random.split(kk, 4)
        frames.append(int(jax.random.randint(rng_frame, (), 0, 235)))
        resets.append(np.asarray(1e-3 * jax.random.normal(rng_noise, (74,))))
    ts = tenv.reset(B, start_frame=torch.tensor(frames),
                    noise=torch.as_tensor(np.stack(resets)))
    mode = make_inference_fn(compat.policy_from_numpy(
        compat.KEEPER_POLICY, device="cpu"))(deterministic=True)
    feed = iter(noises)
    tfinal, troll = generate_unroll(
        tenv, ts, lambda traj, obs, gen: mode(traj, obs,
                                              latent_noise=next(feed)),
        None, STEPS)

    assert troll.reward.shape == (STEPS, B)
    assert troll.observation.shape == (STEPS, B, 232)
    np.testing.assert_allclose(troll.observation.numpy(),
                               np.asarray(jroll.observation), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(troll.action.numpy(),
                               np.asarray(jroll.action), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(troll.reward.numpy(),
                               np.asarray(jroll.reward), atol=1e-4)
    np.testing.assert_array_equal(troll.discount.numpy(),
                                  np.asarray(jroll.discount))
    np.testing.assert_allclose(tfinal.obs.numpy(), np.asarray(jfinal.obs),
                               rtol=1e-2, atol=1e-2)
