"""RodentMultiClipTracking of vnl_tpu_torch against vnl_tpu's on the rodent
twin, with a library of 5 clips of 50 frames chunked from the twin's clip
(the JAX package's process_recording; the port gets the same arrays).

- Reset of B = 3 envs with the clip ids, start frames and noise the JAX
  reset drew, pinned in the port's reset; then two control steps with
  the same actions, the port with its unfused position stage (the JAX
  env's on the CPU).  Observations and features at rtol/atol 1e-3, the
  reward and its terms at atol 1e-6, as tests/test_torch_rollout.py; the
  clip ids and frames exactly.
- Clip-id draws under weights: the same seed gives the same ids, a clip
  of weight 0 is never drawn, the frequencies follow the weights.
- The adaptive weight formula (training/train.py clip_weights_from_metrics)
  against the JAX trainer's (vnl_tpu/training/train.py:312-318) on the same
  per-clip metrics, and a tiny CPU training run with
  ``adaptive_clip_weights`` that logs weights summing to 1."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu.data import pipeline as jpipeline
from vnl_tpu.envs.rodent import RodentMultiClipTracking as JMulti
from vnl_tpu.envs.wrappers import VmapWrapper
from vnl_tpu_torch import compat, models as tmodels
from vnl_tpu_torch.data import ClipLibrary, ReferenceClip
from vnl_tpu_torch.envs import RodentMultiClipTracking, compile_rodent
from vnl_tpu_torch.training import train
from vnl_tpu_torch.training.train import clip_weights_from_metrics
from vnl_tpu_torch.utils import load_config

import torch_parity as tp

B, CLIP_LENGTH, NCLIPS = 3, 50, 5
TERMS = ("rcom", "rvel", "rtrunk", "rquat", "ract", "rapp",
         "termination_error")


def env_args():
    cfg = load_config(f"{tp.ROOT}/vnl_tpu_torch/configs/"
                      "rodent_twin_config.yaml")["env"]["env_args"]
    return dict(cfg, clip_length=CLIP_LENGTH, mjcf_path=tp.TWIN_XML)


@pytest.fixture(scope="module")
def envs():
    with np.load(compat.TWIN_CLIP) as z:
        qpos = np.concatenate([z["position"], z["quaternion"], z["joints"]],
                              1)
    jlib = jpipeline.process_recording(tp.jax_twin(), qpos,
                                       clip_length=CLIP_LENGTH)
    jenv = JMulti(clip_library=jlib, **env_args())
    kw = env_args()
    model = compile_rodent(kw.pop("mjcf_path"), kw.pop("scale_factor"),
                           kw.pop("solver"), kw.pop("iterations"),
                           kw.pop("ls_iterations"), device="cpu")
    tlib = ClipLibrary(
        clips=ReferenceClip(**{
            f.name: torch.tensor(np.asarray(getattr(jlib.clips, f.name)))
            for f in dataclasses.fields(ReferenceClip)
            if getattr(jlib.clips, f.name) is not None}),
        weights=torch.tensor(np.asarray(jlib.weights)))
    tenv = RodentMultiClipTracking(model, tlib, fused_position=False, **kw)
    return jenv, tenv


@pytest.fixture(scope="module")
def rollouts(envs):
    """Both envs reset alike and stepped twice with the same actions."""
    jenv, tenv = envs
    keys = jax.random.split(jax.random.PRNGKey(31), B)
    wenv = VmapWrapper(jenv)
    js = jax.jit(wenv.reset)(keys)
    noise = np.stack([np.asarray(1e-3 * jax.random.normal(
        jax.random.split(k, 4)[1], (74,))) for k in keys])
    ts = tenv.reset(B, start_frame=torch.as_tensor(np.asarray(
        js.info["cur_frame"])), noise=torch.as_tensor(noise),
        clip_id=torch.as_tensor(np.asarray(js.info["clip_id"])))
    out = [(js, ts)]
    step = jax.jit(wenv.step)
    rng = np.random.default_rng(32)
    for _ in range(2):
        action = rng.uniform(-1, 1, size=(B, 30)).astype(np.float32)
        js = step(js, jnp.asarray(action))
        ts = tenv.step(ts, torch.as_tensor(action))
        out.append((js, ts))
    return out


def test_reset_matches(rollouts):
    js, ts = rollouts[0]
    ids = np.asarray(js.info["clip_id"])
    assert len(set(ids.tolist())) > 1, ids      # different clips per env
    np.testing.assert_array_equal(ts.info["clip_id"].numpy(), ids)
    np.testing.assert_array_equal(ts.info["cur_frame"].numpy(),
                                  np.asarray(js.info["cur_frame"]))
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(ts.info["traj"], js.info["traj"], 1e-3, 1e-3, "traj")
    tp.assert_close(ts.info["termination_error"],
                    js.info["termination_error"], 1e-6, 1e-6, "term")


@pytest.mark.parametrize("step", [1, 2])
def test_steps_match(rollouts, step):
    js, ts = rollouts[step]
    np.testing.assert_array_equal(ts.info["clip_id"].numpy(),
                                  np.asarray(js.info["clip_id"]))
    np.testing.assert_array_equal(ts.info["cur_frame"].numpy(),
                                  np.asarray(js.info["cur_frame"]))
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(ts.info["traj"], js.info["traj"], 1e-3, 1e-3, "traj")
    for k in TERMS:
        tp.assert_close(ts.metrics[k], js.metrics[k], 0, 1e-6, k)
    tp.assert_close(ts.reward, js.reward, 0, 1e-6, "reward")
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))


def test_weighted_clip_draws(envs):
    _, tenv = envs
    lib = tenv.clip_library
    w = torch.tensor([0.1, 0.0, 0.5, 0.0, 0.4])

    def ids(seed, n=4000, **kw):
        return lib.sample_id(n, torch.Generator().manual_seed(seed), **kw)

    a = ids(3, weights=w)
    assert torch.equal(a, ids(3, weights=w))
    assert not torch.equal(a, ids(4, weights=w))
    freq = torch.bincount(a, minlength=NCLIPS).numpy() / len(a)
    assert freq[1] == 0 and freq[3] == 0
    np.testing.assert_allclose(freq, w.numpy(), atol=0.03)
    # the library's own weights (all ones): every clip drawn
    assert set(ids(5, n=64).tolist()) == set(range(NCLIPS))
    # the env's reset draws with the weights it is given
    st = tenv.reset(4, generator=torch.Generator().manual_seed(6),
                    clip_weights=torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0]))
    assert st.info["clip_id"].tolist() == [2, 2, 2, 2]


def jax_clip_weights(metrics, n):
    """The JAX trainer's formula, vnl_tpu/training/train.py:312-318."""
    rew = np.zeros(n)
    for c in range(n):
        rew[c] = float(metrics.get(f"eval/episode_reward_clip{c}", 0.0))
    deficit = 1.0 - rew / (rew.max() + 1e-8)
    w = np.maximum(deficit, 0.0) + 0.25
    return w / w.sum()


@pytest.mark.parametrize("rewards", [
    {0: 0.5, 1: 1.0, 2: 0.25, 3: 0.0, 4: 0.9},
    {0: 0.3, 2: 0.3},                          # clips 1, 3, 4 not evaluated
    {0: -0.2, 1: 0.4, 2: 0.1, 3: 0.4, 4: 0.05},
])
def test_adaptive_weight_formula(rewards):
    metrics = {f"eval/episode_reward_clip{c}": np.float32(r)
               for c, r in rewards.items()}
    metrics["eval/episode_reward"] = 1.0
    got = clip_weights_from_metrics(metrics, NCLIPS)
    np.testing.assert_allclose(got, jax_clip_weights(metrics, NCLIPS),
                               rtol=1e-12)
    assert abs(got.sum() - 1) < 1e-12 and got.min() > 0


def test_training_logs_adaptive_weights(envs):
    _, tenv = envs
    kw = env_args()
    for k in ("mjcf_path", "scale_factor", "solver", "iterations",
              "ls_iterations"):
        kw.pop(k)
    # two substeps a control step: the trainer is under test, not physics
    tenv = RodentMultiClipTracking(tenv.sys, tenv.clip_library,
                                   fused_position=False,
                                   physics_steps_per_control_step=2, **kw)
    logged = []
    factory = functools.partial(
        tmodels.make_intention_ppo_networks, intention_latent_size=8,
        encoder_layer_sizes=(16,), decoder_layer_sizes=(16,),
        value_hidden_layer_sizes=(16,))
    train(tenv, num_timesteps=16, episode_length=4, num_envs=4,
          num_eval_envs=5, unroll_length=2, batch_size=4,
          num_minibatches=2, num_updates_per_batch=1, num_evals=2,
          network_factory=factory, adaptive_clip_weights=True,
          progress_fn=lambda step, m: logged.append(dict(m)), device="cpu")
    last = logged[-1]
    w = np.array([last[f"training/clip_weight_{c}"] for c in range(NCLIPS)])
    np.testing.assert_allclose(w.sum(), 1.0, atol=1e-6)
    np.testing.assert_allclose(w, clip_weights_from_metrics(last, NCLIPS),
                               rtol=1e-6)
    assert "training/clip_weight_0" not in logged[0]    # before training
