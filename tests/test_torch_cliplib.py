"""The clip-library probe of vnl_tpu_torch (bench_cliplib) against the rule
of the JAX tool (tools/bench_cliplib.py:44-55) on the rodent twin's
250-frame recording.

- At 2 and 8 clips the probe's library equals the tool's rule applied
  with vnl_tpu.data.pipeline.process_recording: clip count, clip length,
  and every feature at atol 1e-5 (the velocities, float32 differences
  divided by dt = 0.02, at 1e-3, as tests/test_torch_data.py holds
  process_recording);
- at 64 clips the port's library is the 10 clips of 25 frames tiled and
  cut to 64, with the sub-clip length of the tool's rule;
- a two-step eager run at 4 envs on the CPU (the unfused stage, two
  substeps a control step) stays finite, every env on a clip of the
  library."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import export_torch_assets as exporter
from vnl_tpu.data import pipeline as jpipeline
from vnl_tpu_torch import bench_cliplib
from vnl_tpu_torch import mjcf as tmjcf
from vnl_tpu_torch.utils import apply_overrides, load_config

import torch_parity as tp
from test_torch_data import assert_clip_close


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread here: the test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def twin():
    cfg = load_config(bench_cliplib.TWIN_CONFIG)
    return (cfg, bench_cliplib.recording(cfg, device="cpu"),
            tmjcf.load_model(tp.TWIN_XML, device="cpu",
                             **exporter.TWIN_COMPILE))


def jax_tool_library(qpos, n_clips):
    """tools/bench_cliplib.py:44-55 on the twin compiled by vnl_tpu."""
    jm = tp.jax_twin()
    base_len = max(25, (qpos.shape[0] // max(2, min(n_clips, 10))))
    lib = jpipeline.process_recording(jm, qpos, clip_length=base_len)
    reps = int(np.ceil(n_clips / lib.num_clips))
    if reps > 1:
        lib = jax.tree_util.tree_map(
            lambda x: None if x is None else jnp.tile(
                x, (reps,) + (1,) * (x.ndim - 1)), lib)
    return jax.tree_util.tree_map(
        lambda x: None if x is None else x[:n_clips], lib)


@pytest.mark.parametrize("n_clips,clip_length", [(2, 125), (8, 31)])
def test_library_follows_the_tools_rule(twin, n_clips, clip_length):
    cfg, qpos, tm = twin
    assert qpos.shape == (250, 74)
    want = jax_tool_library(qpos, n_clips)
    got = bench_cliplib.library(tm, qpos, n_clips)
    assert (got.num_clips, got.clip_length) == (
        want.num_clips, int(want.clip_length)) == (n_clips, clip_length)
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    assert_clip_close(got.clips, want.clips)
    args = bench_cliplib.env_args(cfg, got, "cpu")
    assert (args["clip_length"], args["sub_clip_length"]) == (
        clip_length, min(10, clip_length - 6))


def test_library_of_64_tiles_ten_clips(twin):
    cfg, qpos, tm = twin
    lib = bench_cliplib.library(tm, qpos, 64)
    base = bench_cliplib.library(tm, qpos, 10)
    assert (lib.num_clips, lib.clip_length) == (64, 25)
    assert (base.num_clips, base.clip_length) == (10, 25)
    ids = torch.arange(64) % 10
    for f in dataclasses.fields(lib.clips):
        x = getattr(lib.clips, f.name)
        if x is not None:
            assert torch.equal(x, getattr(base.clips, f.name)[ids]), f.name
    assert bench_cliplib.env_args(cfg, lib, "cpu")["sub_clip_length"] == 10
    assert bench_cliplib.library_mb(lib) == pytest.approx(
        6.4 * bench_cliplib.library_mb(base))


def test_two_eager_steps_on_the_cpu_stay_finite(twin):
    cfg, _, _ = twin
    cfg = apply_overrides(cfg, [
        "env.env_args.fused_position=False",
        "env.env_args.physics_steps_per_control_step=2"])
    (row,) = bench_cliplib.run(4, (8,), device="cpu", steps=2, samples=1,
                               warmup=0, cfg=cfg)
    state = row["state"]
    assert (row["clips"], row["clip_length"]) == (8, 31)
    assert row["graph"] is None and len(row["sample_s"]) == 1
    for x in (state.pipeline_state.qpos, state.pipeline_state.qvel,
              state.reward, state.obs):
        assert bool(torch.isfinite(x).all())
    assert sum(row["clip_ids"]) == 4 and len(row["clip_ids"]) == 8
    assert row["env_steps_per_s"] > 0
