"""The evaluation side of the training command line against the JAX
package's (kept apart from tests/test_torch_cli.py so that each file stays
under a minute on one worker):

- the multi-clip eval env that vnl_tpu_torch/train.py build_env makes,
  against root train.build_env's: a reset at frame 0 with the JAX reset's
  clip ids and noise, and one step with the same actions, the port on its
  unfused stage, at the rollout test's tolerances (1e-3 observations, 1e-6
  rewards);
- the eval callback's deterministic episode with the keeper policy over 10
  steps on the twin's eval env (the whole clip from frame 0) against
  vnl_tpu's ``EvalCallback(render=False, plots=False)``, fed the JAX
  callback's draws (reset noise; per step the latent, action and uniform
  noise of its step key): every diagnostic at rtol/atol 1e-3; the params
  file it saved loads back as the keeper."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jtrain
from vnl_tpu import models as jmodels
from vnl_tpu.envs.wrappers import VmapWrapper
from vnl_tpu.training import running_statistics as jrs
from vnl_tpu.training.eval_callback import EvalCallback as JEvalCallback
from vnl_tpu_torch import compat
from vnl_tpu_torch import train as ttrain
from vnl_tpu_torch.training.eval_callback import EvalCallback

import torch_parity as tp
from test_torch_cli import _cfg, clip_pickle  # noqa: F401 (fixture)
from test_torch_policy import _unflatten

B, STEPS = 2, 10


def keeper_jax():
    """The keeper's networks and (normaliser, params) in vnl_tpu."""
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
    return net, (norm, {"params": _unflatten(flat)})


def test_multiclip_eval_env_resets_and_steps_alike(clip_pickle):
    cfg = _cfg("rodent_multiclip", clip_pickle)
    jenv = jtrain.build_env(cfg, for_eval=True)
    cfg["env"]["env_args"]["fused_position"] = False    # like with like
    tenv = ttrain.build_env(cfg, for_eval=True, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(43), B)
    wenv = VmapWrapper(jenv)
    js = jax.jit(wenv.reset)(keys)
    np.testing.assert_array_equal(np.asarray(js.info["cur_frame"]), 0)
    noise = np.stack([np.asarray(1e-3 * jax.random.normal(
        jax.random.split(k, 4)[1], (74,))) for k in keys])
    ts = tenv.reset(B, start_frame=torch.zeros(B, dtype=torch.long),
                    noise=torch.as_tensor(noise),
                    clip_id=torch.tensor(np.asarray(js.info["clip_id"])))
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "reset obs")
    tp.assert_close(ts.info["traj"], js.info["traj"], 1e-3, 1e-3, "traj")
    action = np.random.default_rng(44).uniform(
        -1, 1, size=(B, 30)).astype(np.float32)
    jn = jax.jit(wenv.step)(js, jnp.asarray(action))
    tn = tenv.step(ts, torch.as_tensor(action))
    tp.assert_close(tn.obs, jn.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(tn.reward, jn.reward, 0, 1e-6, "reward")
    np.testing.assert_array_equal(tn.info["clip_id"].numpy(),
                                  np.asarray(jn.info["clip_id"]))


def _jax_draws(calls=0, steps=STEPS):
    """The draws of vnl_tpu's EvalCallback rollout (eval_callback.py:
    57-87) for call number ``calls``: the reset noise, and per step the
    latent noise of the net key and the action / uniform noise of the
    draw key (ppo_networks.py mode and sampling policies)."""
    rng, reset_key = jax.random.split(jax.random.PRNGKey(calls))
    rng_noise = jax.random.split(reset_key, 4)[1]
    out = {"start_frame": torch.zeros(1, dtype=torch.long),
           "reset": torch.tensor(np.asarray(
               1e-3 * jax.random.normal(rng_noise, (74,))))[None],
           "latent": [], "action": [], "uniform": []}
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        draw_rng, net_rng = jax.random.split(key)
        for name, x in (
                ("latent", jax.random.normal(net_rng, (64,))),
                ("action", jax.random.normal(draw_rng, (30,))),
                ("uniform", jax.random.uniform(draw_rng, (30,), minval=-1.0,
                                               maxval=1.0))):
            out[name].append(torch.tensor(np.asarray(x))[None])
    return out


def test_eval_callback_matches(clip_pickle, tmp_path):
    cfg = _cfg("rodent", clip_pickle)
    cfg["train"]["episode_length"] = STEPS
    jenv = jtrain.build_env(cfg, for_eval=True)
    cfg["env"]["env_args"]["fused_position"] = False    # like with like
    tenv = ttrain.build_env(cfg, for_eval=True, device="cpu")

    net, params = keeper_jax()
    jcb = JEvalCallback(jenv, jmodels.make_inference_fn(net),
                        str(tmp_path / "jax"), episode_length=STEPS,
                        render=False, plots=False)
    want = jcb(100, None, params)

    cb = EvalCallback(tenv, str(tmp_path / "port"), episode_length=STEPS,
                      plots=False)
    keeper = compat.policy_from_numpy(compat.KEEPER_POLICY, device="cpu")
    traj = cb.rollout(keeper, noise=_jax_draws())
    got = cb.diagnostics(traj)
    assert set(got) == {k for k in want if k.startswith("diag/")}
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-3, atol=1e-3,
                                   err_msg=k)
    assert traj["action"].shape == (STEPS, 30)

    # the callback itself: saves the params it evaluates, logs the series
    logged = []

    class Logger:
        def log(self, series, step):
            logged.append((step, series))

    cb = EvalCallback(tenv, str(tmp_path / "port"), Logger(),
                      episode_length=STEPS, plots=False)
    series = cb(100, (None, keeper.state_dict()))
    saved = compat.policy_from_numpy(
        os.path.join(tmp_path, "port", "100.npz"), device="cpu")
    for k, v in keeper.state_dict().items():
        assert torch.equal(saved.state_dict()[k], v), k
    assert logged == [(100, series)] and series["diag/eval_callback_s"] > 0
    for k in got:
        assert np.isfinite(series[k]), k
