"""The training command line of vnl_tpu_torch (vnl_tpu_torch/train.py)
against the root train.py of the JAX package.

- ``load_config`` and ``apply_overrides`` equal vnl_tpu.utils' (values
  and their types) with every config of configs/ and
  vnl_tpu_torch/configs/ as the env group; the port's configs are the
  JAX package's but for the assets' paths.
- ``build_env`` against root ``train.build_env`` on the same config, for
  "rodent" and "rodent_multiclip", for training and for evaluation, both
  on the twin's XML and a clip pickle: every model field, the clip (or
  the clip library) and the settings of the eval convention; then, for
  "rodent", a reset at frame 0 with the JAX reset's noise and one step
  with the same actions, the port on its unfused stage, at the rollout
  test's tolerances (1e-3 observations, 1e-6 rewards).  The same for
  "rodent_multiclip", and the eval callback, are in
  tests/test_torch_cli_eval.py (each file stays under a minute).
- ``main([...], device="cpu")`` end to end at narrow widths writes the
  metrics JSONL, params per evaluation, full-state checkpoints and
  ``finished.npz``, which loads back through compat.policy_from_numpy;
  the same with vnl_tpu_torch/configs/humanoid_config.yaml (the
  HumanoidTracking env on the committed dm_control humanoid and its
  built-in clip; build_env equal to root train.build_env's model)."""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jtrain
from tools import export_torch_assets as exporter
from vnl_tpu.data.pipeline import save_clip_pickle as jsave_clip_pickle
from vnl_tpu.envs.wrappers import VmapWrapper
from vnl_tpu.utils import apply_overrides as japply
from vnl_tpu.utils import load_config as jload
from vnl_tpu_torch import compat
from vnl_tpu_torch import train as ttrain
from vnl_tpu_torch.utils import apply_overrides, load_config

import torch_parity as tp

CONFIGS = sorted(glob.glob(f"{tp.ROOT}/configs/*.yaml")
                 + glob.glob(f"{tp.ROOT}/vnl_tpu_torch/configs/*.yaml"))
TWIN_CONFIG = f"{tp.ROOT}/vnl_tpu_torch/configs/rodent_twin_config.yaml"
B = 2


def same(a, b):
    """Equal values of equal types, recursively (True is not 1)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("env_cfg", CONFIGS, ids=os.path.basename)
def test_load_config_and_overrides_match(env_cfg):
    train_cfg = f"{tp.ROOT}/vnl_tpu_torch/configs/train_config.yaml"
    overrides = ["train.num_timesteps=40960", "train.eval_every=2.048e4",
                 "env.env_args.clip_length=50", "train.restore_checkpoint="
                 "/tmp/x/40960.npz", "train.adaptive_clip_weights=True",
                 "train.encoder_layer_sizes=[32, 16]", "env.name=rodent",
                 "new.key.deep=None"]
    got = apply_overrides(load_config(train_cfg, env_cfg), overrides)
    want = japply(jload(train_cfg, env_cfg), overrides)
    assert same(got, want)
    with pytest.raises(ValueError):
        apply_overrides({}, ["no_equals_sign"])


def test_port_configs_are_the_jax_ones():
    """The port's configs are copies: the train config is the same
    (render_eval true in both), the env config differs only in its assets'
    paths."""
    port, jax_cfg = (f"{tp.ROOT}/vnl_tpu_torch/configs",
                     f"{tp.ROOT}/configs")
    got = load_config(f"{port}/train_config.yaml")
    want = jload(f"{jax_cfg}/train_config.yaml")
    assert want["train"].pop("render_eval") is True
    assert got["train"].pop("render_eval") is True
    assert same(got, want)
    got = load_config(f"{port}/env_config.yaml")["env"]
    want = jload(f"{jax_cfg}/env_config.yaml")["env"]
    for cfg in (got, want):
        cfg["clip_path"] = os.path.basename(cfg["clip_path"])
        cfg["env_args"]["mjcf_path"] = os.path.basename(
            cfg["env_args"]["mjcf_path"])
    assert same(got, want)
    twin = load_config(TWIN_CONFIG)["env"]["env_args"]
    for k, v in want["env_args"].items():
        if k != "mjcf_path":
            assert same(twin[k], v), k


def _cfg(name, clip_pickle):
    cfg = load_config(f"{tp.ROOT}/vnl_tpu_torch/configs/train_config.yaml",
                      TWIN_CONFIG)
    over = [f"env.name={name}", f"env.clip_path={clip_pickle}",
            f"env.env_args.mjcf_path={tp.TWIN_XML}"]
    if name == "rodent_multiclip":
        over.append("env.env_args.clip_length=50")
    return apply_overrides(cfg, over)


@pytest.fixture(scope="module")
def clip_pickle(tmp_path_factory):
    """The twin's clip as a pickle of numpy leaves, written by vnl_tpu."""
    from vnl_tpu.data.reference_clip import ReferenceClip as JClip
    with np.load(compat.TWIN_CLIP) as z:
        clip = JClip(**{k: z[k] for k in z.files})
    return jsave_clip_pickle(str(tmp_path_factory.mktemp("clip") / "twin.p"),
                             clip)


def _clip_of(env, jax_side):
    if jax_side:
        lib = getattr(env, "_library", None)
        return env._ref_clip if lib is None else lib.clips
    lib = getattr(env, "clip_library", None)
    return env.reference_clip if lib is None else lib.clips


@pytest.mark.parametrize("for_eval", [False, True], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["rodent", "rodent_multiclip"])
def test_build_env_matches(name, for_eval, clip_pickle):
    cfg = _cfg(name, clip_pickle)
    jenv = jtrain.build_env(cfg, for_eval=for_eval)
    tenv = ttrain.build_env(cfg, for_eval=for_eval, device="cpu")
    want = exporter.model_to_numpy(jenv.sys)
    for k, w in want.items():
        g = getattr(tenv.sys, k, None)
        if k.startswith("opt_"):
            g = getattr(tenv.sys.opt, k[4:])
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        np.testing.assert_array_equal(g, w, err_msg=k)
    jclip, tclip = _clip_of(jenv, True), _clip_of(tenv, False)
    for f in dataclasses.fields(tclip):
        w, g = getattr(jclip, f.name), getattr(tclip, f.name)
        assert (w is None) == (g is None), f.name
        if w is not None:
            # the library is processed by each package's own kinematics
            tp.assert_close(g, np.asarray(w), 0, 1e-3 if "vel" in f.name
                            else 1e-5, f.name)
    for attr in ("_clip_length", "_sub_clip_length", "_min_sub_clip_length",
                 "_ref_traj_length", "_termination_threshold"):
        assert getattr(tenv, attr) == getattr(jenv, attr), attr
    assert tenv.n_frames == jenv._n_frames


def test_built_env_resets_and_steps_alike(clip_pickle,
                                          name="rodent"):
    """The eval env: its episodes start at frame 0.  (The multi-clip
    env's case is in tests/test_torch_cli_eval.py.)"""
    cfg = _cfg(name, clip_pickle)
    jenv = jtrain.build_env(cfg, for_eval=True)
    cfg["env"]["env_args"]["fused_position"] = False    # like with like
    tenv = ttrain.build_env(cfg, for_eval=True, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(41), B)
    wenv = VmapWrapper(jenv)
    js = jax.jit(wenv.reset)(keys)
    np.testing.assert_array_equal(np.asarray(js.info["cur_frame"]), 0)
    noise = np.stack([np.asarray(1e-3 * jax.random.normal(
        jax.random.split(k, 4)[1], (74,))) for k in keys])
    kw = {}
    if name == "rodent_multiclip":
        kw["clip_id"] = torch.as_tensor(np.asarray(js.info["clip_id"]))
    ts = tenv.reset(B, start_frame=torch.zeros(B, dtype=torch.long),
                    noise=torch.as_tensor(noise), **kw)
    tp.assert_close(ts.obs, js.obs, 1e-3, 1e-3, "reset obs")
    tp.assert_close(ts.info["traj"], js.info["traj"], 1e-3, 1e-3, "traj")
    action = np.random.default_rng(42).uniform(
        -1, 1, size=(B, 30)).astype(np.float32)
    jn = jax.jit(wenv.step)(js, jnp.asarray(action))
    tn = tenv.step(ts, torch.as_tensor(action))
    tp.assert_close(tn.obs, jn.obs, 1e-3, 1e-3, "obs")
    tp.assert_close(tn.info["traj"], jn.info["traj"], 1e-3, 1e-3, "traj")
    tp.assert_close(tn.reward, jn.reward, 0, 1e-6, "reward")
    np.testing.assert_array_equal(tn.done.numpy(), np.asarray(jn.done))


NARROW = ["train.num_envs=4", "train.batch_size=2", "train.num_minibatches=2",
          "train.unroll_length=4", "train.num_updates_per_batch=2",
          "train.episode_length=6", "train.num_eval_envs=2",
          "train.eval_every=16", "train.intention_latent_size=8",
          "train.encoder_layer_sizes=[32]", "train.decoder_layer_sizes=[32]",
          "train.value_hidden_layer_sizes=[32]",
          "env.env_args.physics_steps_per_control_step=2",
          "env.env_args.fused_position=False"]


def test_main_end_to_end(tmp_path):
    args = [f"env_config={TWIN_CONFIG}",
            f"env.clip_path={compat.TWIN_CLIP}",
            f"env.env_args.mjcf_path={tp.TWIN_XML}",
            "train.num_timesteps=32",
            f"train.checkpoint_dir={tmp_path / 'ck'}",
            f"train.log_dir={tmp_path / 'logs'}"] + NARROW
    make_policy, (normalizer, policy_state), metrics = ttrain.main(
        args, device="cpu")
    assert np.isfinite(metrics["training/total_loss"])
    (run,) = glob.glob(str(tmp_path / "ck" / "*"))
    assert {"32.npz", "finished.npz", "state"} <= set(os.listdir(run))
    assert os.listdir(os.path.join(run, "state")) == ["32.npz"]
    policy = compat.policy_from_numpy(os.path.join(run, "finished.npz"),
                                      device="cpu")
    for k, v in policy_state.items():
        assert torch.equal(policy.state_dict()[k], v), k
    (log,) = glob.glob(str(tmp_path / "logs" / "metrics_*.jsonl"))
    records = [json.loads(line) for line in open(log)]
    assert "_config" in records[0]
    steps = [r["_step"] for r in records[1:]]
    assert steps == [0, 32, 32], steps      # eval, eval, eval callback
    diag = records[-1]
    for k in ("diag/rtrunk_min", "diag/rtrunk_mean", "diag/action_std",
              "diag/episode_reward_det", "diag/log_prob",
              "diag/eval_callback_s"):
        assert np.isfinite(diag[k]), k
    assert "training/sps" in records[2] and "eval/episode_reward" in \
        records[1]


def test_unported_paths_raise():
    """Every path of the command line is ported (rendering, which raised
    here before, is held by tests/test_torch_render.py); what still raises
    is what the JAX trainer refuses too: a device count that is not the
    process count, and, across processes, adaptive clip weights."""
    from vnl_tpu_torch.training import train
    with pytest.raises(ValueError, match="num_devices=2"):
        train(None, 1, 1, num_devices=2, device="cpu")


HUMANOID_CONFIG = f"{tp.ROOT}/vnl_tpu_torch/configs/humanoid_config.yaml"


def test_main_humanoid_end_to_end(tmp_path):
    """One interval of the humanoid command line at narrow widths."""
    args = [f"env_config={HUMANOID_CONFIG}", "train.num_timesteps=32",
            f"train.checkpoint_dir={tmp_path / 'ck'}",
            f"train.log_dir={tmp_path / 'logs'}"] + NARROW
    _, _, metrics = ttrain.main(args, device="cpu")
    assert np.isfinite(metrics["training/total_loss"])
    (run,) = glob.glob(str(tmp_path / "ck" / "*"))
    assert {"32.npz", "finished.npz", "state"} <= set(os.listdir(run))
    policy = compat.policy_from_numpy(os.path.join(run, "finished.npz"),
                                      device="cpu")
    # traj 630 = 5 x (16 x 3 x 2 + 3 + 21) features, obs 55 = nq + nv
    assert policy.encoder.proj_0.in_features == 630
    cfg = apply_overrides(load_config(
        f"{tp.ROOT}/vnl_tpu_torch/configs/train_config.yaml",
        HUMANOID_CONFIG), NARROW)
    tenv = ttrain.build_env(cfg, device="cpu")
    assert type(tenv).__name__ == "HumanoidTracking"
    assert tenv.sys.nv == 27 and tenv.n_frames == 2


def test_build_env_humanoid_matches_jax(monkeypatch):
    """The model root train.build_env compiles for the humanoid config,
    with the committed humanoid as the JAX env's _HUMANOID_XML."""
    from vnl_tpu.envs import humanoid as jhumanoid
    monkeypatch.setattr(jhumanoid, "_HUMANOID_XML", tp.HUMANOID_XML)
    cfg = load_config(f"{tp.ROOT}/vnl_tpu_torch/configs/train_config.yaml",
                      HUMANOID_CONFIG)
    jenv = jtrain.build_env(cfg)
    tenv = ttrain.build_env(cfg, device="cpu")
    want = exporter.model_to_numpy(jenv.sys)
    for k, w in want.items():
        g = getattr(tenv.sys, k, None)
        if k.startswith("opt_"):
            g = getattr(tenv.sys.opt, k[4:])
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        np.testing.assert_array_equal(g, w, err_msg=k)
