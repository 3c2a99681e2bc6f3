"""The data layer of vnl_tpu_torch against vnl_tpu's on the rodent twin.

- ``load_clip`` of a clip pickle written by the JAX package (plain numpy
  leaves), and of a pickled JAX ReferenceClip (jax arrays, a vnl_tpu
  class), equals the JAX ``load_clip``'s arrays exactly;
- ``ClipLibrary``: stacking, ``get``, the per-env ``view`` gathers against
  JAX indexing, and seeded draws;
- ``extract_features`` (with the legacy features) at atol 1e-5 on
  positions and quaternions; ``compute_velocity_from_kinematics``,
  ``process_clip`` and ``process_recording`` (joint-range clip, z offset
  from the 10 lowest feet heights, ``max_qvel`` clip) at atol 1e-3 on the
  velocities, whose float32 differences are divided by dt = 0.02, and 1e-5
  on the rest; ``make_static_clip``;
- the h5 layout written by the port reads back in both packages.
The frames are the exporter's smooth twin trajectory with numpy noise from
a seed."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import export_torch_assets as exporter
from vnl_tpu.data import io as jio
from vnl_tpu.data import pipeline as jpipeline
from vnl_tpu.data import preprocess as jpre
from vnl_tpu.data.reference_clip import ClipLibrary as JLibrary
from vnl_tpu.data.reference_clip import ReferenceClip as JClip
from vnl_tpu_torch import data as tdata
from vnl_tpu_torch import mjcf as tmjcf

import torch_parity as tp

DT = 0.02
POS_ATOL, VEL_ATOL = 1e-5, 1e-3
VEL_FIELDS = ("velocity", "angular_velocity", "joints_velocity")


@pytest.fixture(scope="module")
def models():
    return tp.jax_twin(), tmjcf.load_model(tp.TWIN_XML, device="cpu",
                                           **exporter.TWIN_COMPILE)


def frames(jm, n, seed, scale=0.05):
    """(n, nq) float32 frames: the twin's smooth trajectory plus noise on
    the hinges (some beyond their ranges, for the joint-range clip)."""
    q = exporter.twin_clip_qpos(jm, n_frames=n).astype(np.float64)
    rng = np.random.default_rng(seed)
    q[:, 7:] += scale * rng.normal(size=q[:, 7:].shape)
    return q.astype(np.float32)


def assert_clip_close(got, want, pos_atol=POS_ATOL, vel_atol=VEL_ATOL):
    for f in dataclasses.fields(JClip):
        w = getattr(want, f.name)
        g = getattr(got, f.name)
        assert (g is None) == (w is None), f.name
        if w is None:
            continue
        atol = vel_atol if f.name in VEL_FIELDS else pos_atol
        tp.assert_close(g, np.asarray(w), rtol=0, atol=atol, name=f.name)


def test_load_clip_pickles(models, tmp_path):
    jm, _ = models
    jclip = jpre.process_clip(model=jm, mocap_qpos=frames(jm, 30, 1),
                              clip_length=30)
    plain = jpipeline.save_clip_pickle(str(tmp_path / "plain.p"), jclip)
    with open(tmp_path / "jax.p", "wb") as f:      # jax arrays, flax class
        pickle.dump(jclip, f)
    for path in (plain, str(tmp_path / "jax.p")):
        got = tdata.load_clip(path, device="cpu")
        want = jio.load_clip(plain)
        for fl in dataclasses.fields(JClip):
            w, g = getattr(want, fl.name), getattr(got, fl.name)
            assert (g is None) == (w is None), fl.name
            if w is not None:
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_clip_library(models):
    jm, _ = models
    q = frames(jm, 40, 2)
    jclips = [jpre.process_clip(model=jm, mocap_qpos=q[i:i + 20],
                                clip_length=20) for i in (0, 10, 20)]
    jlib = JLibrary.from_clips(jclips)
    tclips = [tdata.ReferenceClip(**{
        fl.name: (None if getattr(c, fl.name) is None else
                  torch.tensor(np.asarray(getattr(c, fl.name))))
        for fl in dataclasses.fields(JClip)}) for c in jclips]
    tlib = tdata.ClipLibrary.from_clips(tclips)
    assert (tlib.num_clips, tlib.clip_length) == (3, 20)
    assert_clip_close(tlib.get(1), jlib.get(1), 0, 0)

    ids = np.array([2, 0, 1, 2])
    fr = np.array([0, 19, 25, 7])      # frames past the end clamp (an env's
    #                                    frames are never negative)
    got = tlib.view(torch.as_tensor(ids)).at(torch.as_tensor(fr))
    for i, (c, f) in enumerate(zip(ids, np.clip(fr, 0, 19))):
        np.testing.assert_array_equal(got.joints[i].numpy(),
                                      np.asarray(jlib.get(c).joints[f]))
    win = tlib.view(torch.as_tensor(ids)).slice(torch.as_tensor(fr), 5)
    for i, c in enumerate(ids):
        want = jlib.get(int(c)).slice(int(fr[i]), 5)   # clamps like this
        np.testing.assert_array_equal(win.body_positions[i].numpy(),
                                      np.asarray(want.body_positions))

    draw = lambda **kw: tlib.sample_id(
        4000, torch.Generator().manual_seed(5), **kw)
    assert torch.equal(draw(), draw())
    assert set(draw().tolist()) == {0, 1, 2}
    w = torch.tensor([0.7, 0.0, 0.3])
    counts = torch.bincount(draw(weights=w), minlength=3).numpy() / 4000
    assert counts[1] == 0
    np.testing.assert_allclose(counts, w.numpy(), atol=0.03)


def test_extract_features(models):
    jm, tm = models
    q = frames(jm, 60, 3)
    want = jpre.extract_features(jm, jnp.asarray(q), legacy_features=True)
    got = tdata.extract_features(tm, torch.as_tensor(q),
                                 legacy_features=True)
    assert_clip_close(got, want)
    assert got.body_positions.shape == (60, 65, 3)
    assert got.appendages.shape == (60, 5, 3)       # the twin has them all


def test_velocity_from_kinematics(models):
    jm, _ = models
    q = frames(jm, 41, 4)
    want = jpre.compute_velocity_from_kinematics(jnp.asarray(q), DT)
    got = tdata.compute_velocity_from_kinematics(torch.as_tensor(q), DT)
    assert got.shape == (40, 73)
    tp.assert_close(got, np.asarray(want), rtol=0, atol=VEL_ATOL)


def test_process_clip(models):
    jm, tm = models
    q = frames(jm, 80, 5, scale=0.5)           # fast joints: max_qvel bites
    kw = dict(mocap_qpos=q, start_step=10, clip_length=50, max_qvel=20.0)
    want = jpre.process_clip(model=jm, **kw)
    got = tdata.process_clip(model=tm, **kw)
    assert float(got.joints_velocity.abs().max()) == 20.0
    assert_clip_close(got, want)


@pytest.mark.parametrize("adjust_z_offset", [0.0, 1.0])
def test_process_recording(models, adjust_z_offset):
    jm, tm = models
    q = frames(jm, 130, 6, scale=0.3)          # 2 clips of 60, 10 left over
    kw = dict(clip_length=60, adjust_z_offset=adjust_z_offset)
    want = jpipeline.process_recording(jm, q, **kw)
    got = tdata.process_recording(tm, q, **kw)
    assert got.num_clips == 2
    np.testing.assert_array_equal(got.weights.numpy(), [1.0, 1.0])
    assert_clip_close(got.clips, want.clips)


def test_make_static_clip(models):
    jm, tm = models
    q = frames(jm, 1, 7)[0]
    want = jpre.make_static_clip(jm, jnp.asarray(q), clip_length=12)
    got = tdata.make_static_clip(tm, torch.as_tensor(q), clip_length=12)
    assert_clip_close(got, want)


def test_features_h5_roundtrip(models, tmp_path):
    pytest.importorskip("h5py")
    jm, tm = models
    lib = tdata.process_recording(tm, frames(jm, 50, 8), clip_length=25)
    path = tdata.save_features_h5(str(tmp_path / "clips.h5"), lib)
    back = tdata.load_features_h5(path, device="cpu")
    jback = jpipeline.load_features_h5(path)
    assert back.num_clips == jback.num_clips == 2
    for name in ("position", "quaternion", "joints", "velocity",
                 "body_positions", "appendages"):
        np.testing.assert_array_equal(
            getattr(back.clips, name).numpy(),
            np.asarray(getattr(jback.clips, name)), err_msg=name)
    np.testing.assert_array_equal(back.clips.joints.numpy(),
                                  lib.clips.joints.numpy())
