"""The port's examples (vnl_tpu_torch/examples/, the JAX package's
examples/ on the rodent twin) on the CPU:

- rollout_rodent: a 4-step random-action rollout, its termination-error
  curve, the plot and the overlay video;
- train_multiclip: the twin's clip as a library of two 125-frame clips,
  one training step at narrow widths (4 envs, unrolls of 2, two physics
  substeps a control step, the unfused stage), both clips evaluated;
- process_clips: the h5 it writes from the twin clip's qpos (and from the
  same qpos as a STAC pickle) against vnl_tpu.data.pipeline's
  process_recording and save_features_h5 on the same recording with the
  JAX example's compile of the twin, at tests/test_torch_data.py's
  tolerances (1e-5 on positions, 1e-3 on velocities)."""

import functools
import os
import pickle

import h5py
import numpy as np
import pytest
import torch

from vnl_tpu import mjcf as jmjcf
from vnl_tpu.data import pipeline as jpipeline
from vnl_tpu_torch import compat, models
from vnl_tpu_torch.examples import (process_clips, rollout_rodent,
                                    train_multiclip)

import torch_parity as tp
from test_torch_data import POS_ATOL, VEL_ATOL, VEL_FIELDS


def test_rollout_rodent(tmp_path):
    out = rollout_rodent.main(render=True, plot=True, device="cpu", steps=4,
                              out_dir=str(tmp_path))
    err = out["termination_error"]
    assert err.shape == (4,) and np.isfinite(err).all()
    assert out["qpos"].shape == (4, 74)
    assert out["plot"] == str(tmp_path / "rodent_termination_error.png")
    assert os.path.getsize(out["plot"]) > 0
    assert out["video"] == str(tmp_path / "rodent_rollout.gif")
    assert os.path.getsize(out["video"]) > 0


def test_train_multiclip():
    net = functools.partial(
        models.make_intention_ppo_networks, intention_latent_size=8,
        encoder_layer_sizes=(32,), decoder_layer_sizes=(32,),
        value_hidden_layer_sizes=(32,))
    _, (_, policy), metrics = train_multiclip.main(
        8, device="cpu", network_factory=net, num_envs=4, batch_size=2,
        num_minibatches=2, unroll_length=2, episode_length=4,
        num_eval_envs=4,
        env_overrides=dict(fused_position=False,
                           physics_steps_per_control_step=2))
    for k in ("training/total_loss", "training/policy_loss",
              "training/v_loss", "eval/episode_reward_clip0",
              "eval/episode_reward_clip1"):
        assert np.isfinite(metrics[k]), k
    assert all(torch.isfinite(v).all() for v in policy.values())


def _h5_arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]
            out[name + "@attrs"] = dict(obj.attrs)
        f.visititems(visit)
    return out


@pytest.fixture(scope="module")
def jax_h5(tmp_path_factory):
    """The JAX example's pipeline on the twin and the twin clip's qpos."""
    jm = jmjcf.load_model(tp.TWIN_XML, rescale=(0.9, 0.9),
                          torque_actuators=True)
    with np.load(compat.TWIN_CLIP) as z:
        qpos = np.concatenate([z["position"], z["quaternion"], z["joints"]],
                              1)
    lib = jpipeline.process_recording(jm, qpos, clip_length=125)
    path = str(tmp_path_factory.mktemp("jax") / "clips.h5")
    return jpipeline.save_features_h5(path, lib), qpos


@pytest.mark.parametrize("source", ["twin_clip", "stac_pickle"])
def test_process_clips_h5_matches_jax(source, jax_h5, tmp_path):
    want_path, qpos = jax_h5
    stac = None
    if source == "stac_pickle":
        stac = str(tmp_path / "stac.p")
        with open(stac, "wb") as f:
            pickle.dump({"qpos": qpos}, f)
    lib, path = process_clips.main(stac, str(tmp_path / "clips.h5"),
                                   device="cpu")
    assert path == str(tmp_path / "clips.h5")
    assert (lib.num_clips, lib.clip_length) == (2, 125)
    got, want = _h5_arrays(path), _h5_arrays(want_path)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if name.endswith("@attrs"):
            assert g.keys() == w.keys(), name
            for k in w:
                np.testing.assert_allclose(g[k], w[k], err_msg=name)
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        atol = VEL_ATOL if name.rsplit("/", 1)[-1] in VEL_FIELDS else \
            POS_ATOL
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
