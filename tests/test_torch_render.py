"""vnl_tpu_torch.render against vnl_tpu.render on the CPU: the software
renderer, its FK, the skin and the batched egocentric camera, and the eval
callback's overlay video.

Inputs are made with numpy from a seed.  Scenes: a small inline MJCF with
a plane, a sphere, a capsule, a cylinder, an ellipsoid and a box on free,
ball, hinge and slide joints (compiled by each package's own compiler),
and the rodent twin.  Tolerances:
- frames (uint8): they match when at most 0.5% of the pixels differ by
  more than one level in any channel (both renderers cast in float64; a
  pixel can flip only where a ray grazes a silhouette);
- FK against vnl_tpu's ``numpy_fk`` and posed skin vertices: 1e-9
  (float64);
- ``load_skn``: exactly;
- the egocentric camera (float32): within 1e-4 on at least 99.5% of the
  pixels.
"""

import concurrent.futures
import os
import shutil
import struct
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from vnl_tpu import mjcf as jmjcf
from vnl_tpu.render import jit_camera as jcam
from vnl_tpu.render import skin as jskin
from vnl_tpu.render import software as jsoft
from vnl_tpu_torch import compat
from vnl_tpu_torch import mjcf as tmjcf
from vnl_tpu_torch.render import jit_camera as tcam
from vnl_tpu_torch.render import skin as tskin
from vnl_tpu_torch.render import software as tsoft

W, H = 64, 48
PIXEL_SHARE = 0.005     # of the pixels may differ by more than one level

# no contacts: the renderer needs none, and no compiler has every pair
SCENE = """<mujoco>
  <default><geom contype="0" conaffinity="0"/></default>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 .1"/>
    <body name="torso" pos="0 0 0.3">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.06"/>
      <body name="arm" pos="0.1 0 0">
        <joint name="shoulder" type="ball"/>
        <geom name="cap" type="capsule" fromto="0 0 0 0.15 0 0"
              size="0.03"/>
        <body name="hand" pos="0.15 0 0">
          <joint name="wrist" type="hinge" axis="0 0 1"/>
          <geom name="cyl" type="cylinder" size="0.03 0.05"
                pos="0.05 0 0" euler="0 90 0"/>
          <geom name="ell" type="ellipsoid" size="0.04 0.03 0.02"
                pos="0.12 0 0.02"/>
        </body>
      </body>
      <body name="tail" pos="-0.1 0 0">
        <joint name="slide" type="slide" axis="1 0 0"/>
        <geom name="box" type="box" size="0.05 0.04 0.03"
              euler="10 20 30"/>
      </body>
    </body>
  </worldbody>
  {asset}
</mujoco>"""


def frames_match(got, want, share=PIXEL_SHARE):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    off = np.abs(got.astype(int) - want.astype(int)).max(-1) > 1
    assert off.mean() <= share, (off.mean(), off.sum())


@pytest.fixture(scope="module")
def scene():
    jm = jmjcf.load_model(SCENE.format(asset=""))
    return jm, tmjcf.load_model(SCENE.format(asset=""), device="cpu")


@pytest.fixture(scope="module")
def twin():
    jm = tp.jax_twin()
    return jm, tp.torch_model(jm)


def scene_poses(jm, n, seed):
    """(n, nq) float64: random root position and orientation near the
    origin, a random ball rotation, hinge and slide."""
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(jm.qpos0, np.float64), (n, 1))
    q[:, :3] += 0.05 * rng.normal(size=(n, 3))
    for cols in (slice(3, 7), slice(7, 11)):
        quat = np.array([1.0, 0, 0, 0]) + 0.4 * rng.normal(size=(n, 4))
        q[:, cols] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 11] = rng.uniform(-1, 1, n)
    q[:, 12] = rng.uniform(-0.05, 0.05, n)
    return q


def twin_poses(jm, n, seed):
    rng = np.random.default_rng(seed)
    q = np.tile(np.asarray(jm.qpos0, np.float64), (n, 1))
    q[:, :3] += 0.02 * rng.normal(size=(n, 3))
    q[:, 7:] += 0.3 * rng.normal(size=(n, jm.nq - 7))
    return q


def ghost_of(q, seed):
    """The second instance: the pose moved and bent a little."""
    rng = np.random.default_rng(seed)
    g = q.copy()
    g[:, :3] += np.array([0.04, -0.03, 0.0])
    g[:, 7:] += 0.1 * rng.normal(size=g[:, 7:].shape)
    return g


@pytest.mark.parametrize("which", ["scene", "twin"])
def test_fk_matches_numpy_fk(which, scene, twin):
    jm, tm = scene if which == "scene" else twin
    poses = (scene_poses if which == "scene" else twin_poses)(jm, 3, 1)
    for q in poses:
        for got, want in zip(tsoft.numpy_fk(tm, q), jsoft.numpy_fk(jm, q)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    xpos, xquat, gx, gm = tsoft.fk(tm, torch.as_tensor(poses))
    want = jsoft.numpy_fk(jm, poses[2])
    for got, w in zip((xpos[2], xquat[2], gx[2], gm[2]), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-9)


@pytest.mark.parametrize("which", ["scene", "twin"])
def test_overlay_frames_match(which, scene, twin):
    """Three seeded poses, each an opaque agent and a translucent ghost,
    one frame at a time as the JAX renderer draws them and all three in
    one batched call, also cut into chunks of one frame."""
    jm, tm = scene if which == "scene" else twin
    poses = (scene_poses if which == "scene" else twin_poses)(jm, 3, 2)
    ghosts = ghost_of(poses, 3)
    jr = jsoft.SoftwareRenderer(jm, W, H)
    want = np.stack([jr.render([q, g]) for q, g in zip(poses, ghosts)])
    tr = tsoft.SoftwareRenderer(tm, W, H, device="cpu")
    for k in range(3):
        frames_match(tr.render([poses[k], ghosts[k]]), want[k])
    both = torch.as_tensor(np.stack([poses, ghosts], 1))
    batched = tr.render_frames(both).numpy()
    frames_match(batched, want)
    one_a_chunk = tsoft.SoftwareRenderer(tm, W, H, device="cpu",
                                         chunk_bytes=1)
    assert np.array_equal(one_a_chunk.render_frames(both).numpy(), batched)
    assert (batched != 255).any(axis=-1).mean() > 0.5   # not blank


def test_camera_arguments_and_colors(scene):
    jm, tm = scene
    q = scene_poses(jm, 1, 4)[0]
    kw = dict(camera_pos=np.array([0.6, 0.5, 0.7]),
              camera_target=np.array([0.0, 0.0, 0.25]),
              colors=[(0.2, 0.9, 0.3)], alphas=[0.6])
    frames_match(tsoft.SoftwareRenderer(tm, W, H, device="cpu").render(
        [q], **kw), jsoft.SoftwareRenderer(jm, W, H).render([q], **kw))


def test_render_egocentric_and_trajectory(scene, twin):
    """fovy 90 from the twin's skull, where a culling window can cut a
    silhouette; and a trajectory of the scene."""
    jm, tm = twin
    for q in twin_poses(jm, 2, 5):
        frames_match(tsoft.render_egocentric(tm, q, device="cpu"),
                     jsoft.render_egocentric(jm, q))
    jm, tm = scene
    traj = scene_poses(jm, 3, 6)
    frames_match(tsoft.render_trajectory(tm, traj, W, H, device="cpu"),
                 jsoft.render_trajectory(jm, traj, W, H))


# -- skin ---------------------------------------------------------------------

BONES = ("torso", "arm", "hand")


def write_skn(path, jm, seed=0):
    """A synthetic MuJoCo binary skin: a closed ellipsoidal hull of 32
    vertices and 60 faces around the scene's arm, 3 bones named after its
    bodies, bound at qpos0, with 2 texcoords a vertex (skipped by the
    parser) and blended weights."""
    rng = np.random.default_rng(seed)
    rings, seg = 5, 6
    verts = [(0.0, 0.0, 1.0)]
    for i in range(1, rings + 1):
        th = np.pi * i / (rings + 1)
        for j in range(seg):
            ph = 2 * np.pi * j / seg
            verts.append((np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                          np.cos(th)))
    verts.append((0.0, 0.0, -1.0))
    verts = np.asarray(verts) * np.array([0.03, 0.04, 0.2])
    verts = verts[:, [2, 1, 0]] + np.array([0.22, 0.0, 0.3])
    verts += 0.003 * rng.normal(size=verts.shape)
    nv = len(verts)
    faces = [(0, 1 + j, 1 + (j + 1) % seg) for j in range(seg)]
    for i in range(rings - 1):
        a, b = 1 + i * seg, 1 + (i + 1) * seg
        for j in range(seg):
            k = (j + 1) % seg
            faces += [(a + j, b + j, b + k), (a + j, b + k, a + k)]
    last = 1 + (rings - 1) * seg
    faces += [(nv - 1, last + (j + 1) % seg, last + j) for j in range(seg)]
    xpos, xquat, _, _ = jsoft.numpy_fk(jm, np.asarray(jm.qpos0))
    names = list(jm.body_names)
    centres = np.array([0.0, 0.2, 0.35])
    x = verts[:, 0]
    with open(path, "wb") as f:
        f.write(struct.pack("<4i", nv, nv, len(faces), len(BONES)))
        f.write(np.asarray(verts, "<f4").tobytes())
        f.write(rng.uniform(size=(nv, 2)).astype("<f4").tobytes())
        f.write(np.asarray(faces, "<i4").tobytes())
        for b, name in enumerate(BONES):
            bid = names.index(name)
            w = np.exp(-((x - centres[b]) / 0.08) ** 2)
            vid = np.nonzero(w > 0.05)[0]
            f.write(name.encode().ljust(40, b"\0"))
            f.write(struct.pack("<3f", *xpos[bid]))
            f.write(struct.pack("<4f", *xquat[bid]))
            f.write(struct.pack("<i", len(vid)))
            f.write(vid.astype("<i4").tobytes())
            f.write(w[vid].astype("<f4").tobytes())
    return nv, len(faces)


@pytest.fixture(scope="module")
def skins(scene, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("skin") / "hull.skn")
    nv, nf = write_skn(path, scene[0])
    assert (nv, nf) == (32, 60)
    return path, jskin.load_skn(path), tskin.load_skn(path)


@pytest.mark.parametrize("scale", [1.0, 0.9])
def test_load_skn_matches_exactly(skins, scale):
    path = skins[0]
    want, got = jskin.load_skn(path, scale), tskin.load_skn(path, scale)
    assert got.bone_bodies == want.bone_bodies == list(BONES)
    for name in ("verts", "faces", "bindpos", "bindquat", "weights",
                 "local"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def test_skin_vertices_match(scene, skins):
    jm, tm = scene
    _, js, ts = skins
    poses = scene_poses(jm, 3, 7)
    ids = tskin.bone_body_ids(ts, tm.body_names)
    assert np.array_equal(ids, jskin.bone_body_ids(js, jm.body_names))
    xpos, xquat, _, _ = tsoft.fk(tm, torch.as_tensor(poses))
    got = tskin.skin_vertices(ts, ids, xpos, xquat).numpy()
    for k, q in enumerate(poses):
        jx, jq, _, _ = jsoft.numpy_fk(jm, q)
        want = jskin.skin_vertices(js, ids, jx, jq)
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-9)


def test_skinned_frames_match(scene, skins):
    jm, tm = scene
    _, js, ts = skins
    poses = scene_poses(jm, 3, 8)
    ghosts = ghost_of(poses, 9)
    jr = jsoft.SoftwareRenderer(jm, W, H, skin=js)
    tr = tsoft.SoftwareRenderer(tm, W, H, skin=ts, device="cpu")
    want = np.stack([jr.render([q, g]) for q, g in zip(poses, ghosts)])
    got = tr.render_frames(torch.as_tensor(np.stack([poses, ghosts],
                                                    1))).numpy()
    frames_match(got, want)
    # the hull covers part of the frame, and differs from the geoms' frame
    plain = tsoft.SoftwareRenderer(tm, W, H, device="cpu").render(
        [poses[0], ghosts[0]])
    assert (got[0] != plain).any()


def test_skin_file_carried_by_both_compilers(skins, tmp_path):
    """A <skin file=...> asset: the compiled Model's skin_file (the last
    field, written only when set) is the same path in both packages, and
    ``skin="auto"`` renders it."""
    skn = skins[0]
    xml = tmp_path / "scene.xml"
    xml.write_text(SCENE.format(
        asset=f'<asset><skin file="{os.path.basename(skn)}"/></asset>'))
    shutil.copy(skn, tmp_path / os.path.basename(skn))
    jm = jmjcf.load_model(str(xml))
    want = tp.exporter.model_to_numpy(jm)
    got = tmjcf.compile_numpy(tmjcf.load_spec(str(xml)))
    assert str(want["skin_file"]) == jm.skin_file == str(got["skin_file"])
    assert list(got)[-1] == "skin_file"
    assert got["skin_file"].dtype == want["skin_file"].dtype
    tm = compat.model_from_numpy(got, device="cpu")
    assert tm.skin_file == jm.skin_file
    assert compat.model_from_numpy(compat.TWIN_MODEL,
                                   device="cpu").skin_file is None
    q = scene_poses(jm, 1, 10)[0]
    tr = tsoft.SoftwareRenderer(tm, W, H, skin="auto", device="cpu")
    assert tr.skin is not None
    frames_match(tr.render([q]), jsoft.SoftwareRenderer(
        jm, W, H, skin="auto").render([q]))


# -- the egocentric camera ----------------------------------------------------

class Poses(NamedTuple):
    """The fields of Data the camera reads, as a pytree for jax.vmap."""
    xpos: np.ndarray
    xmat: np.ndarray
    geom_xpos: np.ndarray
    geom_xmat: np.ndarray


def test_egocentric_camera_matches_vmap(twin):
    """The poses of 3 twin states from vnl_tpu's host FK (numpy_fk), cast
    by jax.vmap of vnl_tpu's camera and by the port's batched camera."""
    jm, tm = twin
    poses = [jsoft.numpy_fk(jm, q) for q in twin_poses(jm, 3, 11)]
    d = Poses(*(np.stack(x).astype(np.float32) for x in (
        [p[0] for p in poses],
        [[jsoft._np_q2mat(q) for q in p[1]] for p in poses],
        [p[2] for p in poses], [p[3] for p in poses])))
    want = np.asarray(jax.jit(jax.vmap(jcam.make_egocentric_camera(jm)))(
        Poses(*map(jnp.asarray, d))))
    td = Poses(*map(torch.as_tensor, d))
    got = tcam.make_egocentric_camera(tm)(td)
    assert got.shape == (3, 64, 64, 3) and got.dtype == torch.float32
    err = np.abs(got.numpy() - want)
    assert (err <= 1e-4).all(-1).mean() >= 0.995, err.max()
    assert (want > 0.15).mean() > 0.1          # something is in view
    # chunked over the envs, the same images
    chunked = tcam.make_egocentric_camera(tm, chunk_bytes=1)(td)
    assert torch.equal(chunked, got)


# -- the eval callback's overlay video ---------------------------------------

def test_eval_callback_renders_the_overlay(tmp_path):
    """EvalCallback(render=True) on the CPU twin: the job renders the
    agent-vs-reference overlay on the env's device and writes the video;
    here imageio has no mp4 backend, so it writes the .gif, as the JAX
    callback does.  A second call while a render is in flight skips."""
    from vnl_tpu_torch.envs import make_twin_env
    from vnl_tpu_torch.training.eval_callback import EvalCallback
    env = make_twin_env(device="cpu", fused_position=False)
    keeper = compat.policy_from_numpy(compat.KEEPER_POLICY, device="cpu")
    cb = EvalCallback(env, str(tmp_path), episode_length=3, render=True)
    series = cb(7, (None, keeper.state_dict()))
    assert os.path.exists(series["diag/plots"])       # beside the video
    assert series["diag/video"] == os.path.join(str(tmp_path),
                                                "rollout_7.mp4")
    assert series["diag/video_async"] is True
    result = cb.render_result(timeout=120)
    assert result == os.path.join(str(tmp_path), "rollout_7.gif"), result
    assert os.path.getsize(result) > 0
    import imageio
    frames = imageio.mimread(result)
    assert len(frames) == 3 and frames[0].shape[:2] == (240, 320)
    # the pile-up guard: a render still in flight makes the next call skip
    cb._pending_render = concurrent.futures.Future()
    assert cb(8, (None, keeper.state_dict()))["diag/video_skipped"] == \
        "previous render in flight"
    cb._pending_render = None
    cb._render_every = 2      # call 2 renders, call 3 does not
    assert "diag/video" in cb(9, (None, keeper.state_dict()))
    assert cb.render_result(timeout=120).endswith("rollout_9.gif")
    keys = cb(10, (None, keeper.state_dict()))
    assert not any(k.startswith("diag/video") for k in keys)


@pytest.mark.parametrize("kind", ["rodent", "multiclip", "humanoid", "ant",
                                  "standing"])
def test_eval_callback_finds_each_envs_reference_clip(kind, tmp_path):
    """The overlay's reference: the rodent's clip, the multi-clip env's
    clip of the episode's clip id, the humanoid's and the ant's built-in
    clips, frames from the episode's start frame on; none for
    HumanoidStanding, which tracks no clip (its render job returns
    None, as in the JAX package)."""
    from vnl_tpu_torch import train as ttrain
    from vnl_tpu_torch.data import save_clip_pickle
    from vnl_tpu_torch.envs import (AntTracking, HumanoidStanding,
                                    HumanoidTracking, make_twin_env)
    from vnl_tpu_torch.training.eval_callback import EvalCallback
    from vnl_tpu_torch.utils import apply_overrides, load_config
    clip_id = -1
    if kind == "rodent":
        env = make_twin_env(device="cpu", fused_position=False)
        ref = env.reference_clip
    elif kind == "multiclip":
        pickle = str(tmp_path / "clip.p")
        save_clip_pickle(pickle, compat.clip_from_numpy(compat.TWIN_CLIP,
                                                        device="cpu"))
        cfg = apply_overrides(load_config(
            f"{tp.ROOT}/vnl_tpu_torch/configs/train_config.yaml",
            f"{tp.ROOT}/vnl_tpu_torch/configs/rodent_twin_config.yaml"),
            ["env.name=rodent_multiclip", f"env.clip_path={pickle}",
             f"env.env_args.mjcf_path={tp.TWIN_XML}",
             "env.env_args.clip_length=50"])
        env = ttrain.build_env(cfg, for_eval=True, device="cpu")
        clip_id = 2
        ref = env.clip_library.get(clip_id)
    elif kind == "standing":
        env, ref = HumanoidStanding(device="cpu"), None
    else:
        env = (HumanoidTracking if kind == "humanoid" else AntTracking)(
            device="cpu")
        ref = env.reference_clip
    cb = EvalCallback(env, str(tmp_path), episode_length=4, plots=False)
    qpos = np.random.default_rng(0).normal(size=(4, env.sys.nq))
    pair = cb.overlay_inputs(qpos, 3, clip_id)
    if ref is None:
        assert pair is None
        return
    want = torch.cat([ref.position, ref.quaternion, ref.joints],
                     1)[3:7].numpy()
    agent, got = pair
    assert np.array_equal(agent, qpos) and np.array_equal(got, want)
