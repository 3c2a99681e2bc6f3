"""vnl_tpu_torch.render_checkpoint (the rollout video and diagnostic plot
of a saved policy) against the JAX tool's loop (tools/render_checkpoint.py).

- The deterministic rollout on the twin's eval env (frame 0, the whole
  clip, stopping at ``done``) with the keeper for up to 8 steps, fed the
  JAX tool's draws (its reset from ``PRNGKey(0)`` and each step's latent
  from the mode policy's net key), against the tool's loop over vnl_tpu's
  jitted ``env.reset`` / ``env.step`` and ``mode_policy``: rewards, rtrunk
  and qpos at rtol/atol 1e-3 and the same length, the port on its
  unfused stage (like with like, as tests/test_torch_cli_eval.py);
- ``render`` writes the diag PNG and the video (a .gif here, where
  imageio has no mp4 backend), also without matplotlib and imageio
  (utils/images.py), and the files decode;
- with a synthetic skin around the twin (chip_smoke.write_twin_skin,
  built as tests/test_torch_render.py write_skn builds one), the frames it
  renders equal ``overlay_frames(..., skin=...)`` for the same qpos, and
  match vnl_tpu's SoftwareRenderer with the same skin within the render
  tests' rule (at most 0.5% of the pixels more than one level apart);
- the command line on the CPU, and the newest params file by default."""

import json
import os
import sys
import time

import imageio
import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import chip_smoke
import train as jtrain
from vnl_tpu import models as jmodels
from vnl_tpu.render import skin as jskin
from vnl_tpu.render import software as jsoft
from vnl_tpu_torch import compat
from vnl_tpu_torch import render_checkpoint as rc
from vnl_tpu_torch.render.skin import load_skn
from vnl_tpu_torch.render.software import overlay_frames

import torch_parity as tp
from test_torch_cli import _cfg, clip_pickle  # noqa: F401 (fixture)
from test_torch_cli_eval import keeper_jax
from test_torch_eval_checkpoint import short_cfg
from test_torch_render import frames_match

STEPS = 8


def jax_tool_draws(steps=STEPS, latent=64, nq=74):
    """The draws of the JAX tool's loop: the reset noise of PRNGKey(0)
    and, per step, the latent of the mode policy's net key."""
    rng = jax.random.PRNGKey(0)
    out = {"start_frame": torch.zeros(1, dtype=torch.long),
           "reset": torch.tensor(np.asarray(1e-3 * jax.random.normal(
               jax.random.split(rng, 4)[1], (nq,))))[None], "latent": []}
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        _, net_rng = jax.random.split(key)
        out["latent"].append(torch.tensor(np.asarray(
            jax.random.normal(net_rng, (latent,))))[None])
    return out


def jax_tool_rollout(cfg, steps=STEPS):
    """tools/render_checkpoint.py's loop (lines 104-118) on vnl_tpu."""
    env = jtrain.build_env(cfg, for_eval=True)
    net, params = keeper_jax()
    policy = jax.jit(jmodels.make_inference_fn(net)(params,
                                                    deterministic=True))
    step = jax.jit(env.step)
    rng = jax.random.PRNGKey(0)
    state = jax.jit(env.reset)(rng)
    qpos, rtrunk, rewards = [], [], []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        act, _ = policy(state.info["traj"], state.obs, key)
        state = step(state, act)
        qpos.append(np.asarray(state.pipeline_state.qpos))
        rtrunk.append(float(state.metrics["termination_error"]))
        rewards.append(float(state.reward))
        if state.done:
            break
    return np.stack(qpos), np.asarray(rtrunk), np.asarray(rewards)


@pytest.fixture(scope="module")
def port_cfg(clip_pickle):
    cfg = _cfg("rodent", clip_pickle)
    cfg["env"]["env_args"]["fused_position"] = False     # like with like
    return cfg


def test_rollout_matches_the_jax_tool_loop(clip_pickle, port_cfg):
    qpos, rtrunk, rewards = jax_tool_rollout(_cfg("rodent", clip_pickle))
    keeper = compat.policy_from_numpy(compat.KEEPER_POLICY, device="cpu")
    traj, cb = rc.rollout(keeper, port_cfg, device="cpu", steps=STEPS,
                          noise=jax_tool_draws())
    assert len(traj["reward"]) == len(rewards) >= 2
    np.testing.assert_allclose(traj["reward"], rewards, rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(traj["rtrunk"], rtrunk, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(traj["qpos"], qpos, rtol=1e-3, atol=1e-3)
    assert traj["start_frame"] == 0 and traj["clip_id"] == -1
    qa, qr = cb.overlay_inputs(traj["qpos"], 0)
    assert qa.shape == qr.shape == (len(rewards), 74)


def _decoded_gif(path):
    im = Image.open(path)
    return im.n_frames, im.size


def test_render_writes_the_plot_and_the_video(tmp_path, port_cfg,
                                              monkeypatch):
    out = rc.render(compat.KEEPER_POLICY, str(tmp_path / "a"), port_cfg,
                    device="cpu", steps=3)
    n = len(out["traj"]["reward"])
    assert out["diag"] == str(tmp_path / "a_diag.png")
    assert Image.open(out["diag"]).format == "PNG"
    assert out["video"] == str(tmp_path / "a.gif")       # no ffmpeg here
    assert len(imageio.mimread(out["video"])) == n
    assert tuple(out["frames"].shape) == (n, 240, 320, 3)
    # neither matplotlib nor imageio: the numpy writers
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    out2 = rc.render(compat.KEEPER_POLICY, str(tmp_path / "b"), port_cfg,
                     device="cpu", steps=3)
    assert np.asarray(Image.open(out2["diag"])).shape == (650, 910, 3)
    assert out2["video"] == str(tmp_path / "b.gif")
    assert _decoded_gif(out2["video"]) == (n, (320, 240))
    assert torch.equal(out2["frames"], out["frames"])


def test_skinned_frames(tmp_path, port_cfg):
    jm = tp.jax_twin()
    tm = compat.model_from_numpy(compat.TWIN_MODEL, device="cpu")
    skn = str(tmp_path / "hull.skn")
    assert chip_smoke.write_twin_skin(skn, tm, rings=6, seg=8) == (50, 96)
    out = rc.render(compat.KEEPER_POLICY, str(tmp_path / "s"), port_cfg,
                    device="cpu", skin=skn, steps=3)
    traj = out["traj"]
    qa = traj["qpos"]
    clip = compat.clip_from_numpy(compat.TWIN_CLIP, device="cpu")
    qr = torch.cat([clip.position, clip.quaternion, clip.joints],
                   1)[:len(qa)].numpy()
    want = overlay_frames(tm, qa, qr, skin=load_skn(skn), device="cpu")
    assert torch.equal(out["frames"], want)
    plain = overlay_frames(tm, qa, qr, skin=None, device="cpu")
    assert (want != plain).any(-1).float().mean() > 0.002   # the hide shows
    jr = jsoft.SoftwareRenderer(jm, 320, 240, skin=jskin.load_skn(skn))
    frames_match(want.numpy(), np.stack([jr.render([a, r])
                                         for a, r in zip(qa, qr)]))


def test_command_line_and_newest_checkpoint(tmp_path, capsys, monkeypatch):
    run = tmp_path / "model_checkpoints" / "run"
    run.mkdir(parents=True)
    keeper = compat.policy_from_numpy(compat.KEEPER_POLICY, device="cpu")
    for i, name in enumerate(("20480.npz", "40960.npz", "finished.npz")):
        path = str(run / name)
        np.savez(path, **compat.policy_to_numpy(keeper))
        os.utime(path, (time.time() + i, time.time() + i))
    monkeypatch.chdir(tmp_path)
    assert rc.newest_checkpoint() == os.path.join("model_checkpoints", "run",
                                                  "40960.npz")
    monkeypatch.chdir(tp.ROOT)        # the config's paths are the repo's
    ckpt = str(run / "40960.npz")
    cfg = tmp_path / "short.yaml"
    cfg.write_text(yaml.safe_dump(short_cfg()))
    rec = rc.main([ckpt, str(tmp_path / "out"), "--device", "cpu",
                   "--config", str(cfg)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"checkpoint: {ckpt}"
    assert lines[1].startswith("rolled ") and "final rtrunk" in lines[1]
    line = json.loads(lines[-1])["render_checkpoint"]
    assert line == json.loads(json.dumps(rec))
    assert line["diag"] == str(tmp_path / "out_diag.png")
    assert os.path.exists(line["diag"]) and os.path.exists(line["video"])
    assert 1 <= line["steps"] == line["frames"] <= 14      # horizon 15 - 1
    assert line["device"] == "cpu" and np.isfinite(line["reward_mean"])


def test_image_writers_decode(tmp_path):
    """utils/images.py: the PNG decodes to its pixels; the GIF to the 3-3-2
    quantisation of each frame, every frame, in order."""
    from vnl_tpu_torch.utils.images import write_gif, write_png
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    assert np.array_equal(np.asarray(Image.open(
        write_png(str(tmp_path / "a.png"), img))), img)
    frames = rng.integers(0, 256, (3, 240, 320, 3), dtype=np.uint8)
    frames[1, :120] = 0                        # long runs of one colour
    path = write_gif(str(tmp_path / "a.gif"), frames, fps=50)
    got = imageio.mimread(path)
    assert len(got) == 3
    q = frames.astype(int) >> np.array([5, 5, 6])
    want = np.stack([q[..., 0] * 255 // 7, q[..., 1] * 255 // 7,
                     q[..., 2] * 255 // 3], -1)
    for k in range(3):
        assert np.array_equal(np.asarray(got[k])[..., :3], want[k]), k
