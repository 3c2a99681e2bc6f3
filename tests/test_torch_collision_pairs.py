"""The narrowphase pairs of vnl_tpu_torch against vnl_tpu's collide(): the
same geom poses (from the JAX package's kinematics of random states) go
through both, on two inline scenes that hold every pair type between them
and on the dm_control humanoid's 161 candidate pairs (sphere-sphere,
sphere-capsule, capsule-capsule against each other, plane-sphere and
plane-capsule against the floor).  pair_expansion must be equal on every
scene, the ant's included.

Tolerances: distances, contact points and frames at atol 2e-5 (float32
geometry of O(1) values; the two packages evaluate the same formulas).
Plane-box and box-box keep their deepest candidates.  Exact ties (a box
lying exactly flat, env 0 of the box scene) are kept in index order by
both packages, so there the slots must agree.  Candidates a few ulps apart
(face-on-face box-box contact) may swap slots between the two float32
computations, so each pair's kept points are compared as a set: every
point of the port must match a point of the JAX package at the same
tolerance, one to one."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu_torch.physics import collision as tcol
from vnl_tpu_torch.physics import kinematics as tkin

import torch_parity as tp

B = 4

# every pair type beside the floor but capsules: plane-{sphere, cylinder,
# box}, sphere-box, box-box (the cylinder only meets the floor)
BOX_SCENE = """<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="cyl" pos="0 0 0.19"><freejoint/>
      <geom type="cylinder" size="0.1 0.2" density="300"/></body>
    <body name="box1" pos="1 0 0.08"><freejoint/>
      <geom type="box" size="0.1 0.12 0.08" density="300"/></body>
    <body name="box2" pos="1.03 0.02 0.25"><freejoint/>
      <geom type="box" size="0.09 0.1 0.09" density="300"/></body>
    <body name="ball" pos="1.0 0.2 0.1"><freejoint/>
      <geom type="sphere" size="0.1" density="300"/></body>
  </worldbody>
  <contact>
    <exclude body1="cyl" body2="box1"/><exclude body1="cyl" body2="box2"/>
    <exclude body1="cyl" body2="ball"/>
  </contact>
</mujoco>"""

# plane-{sphere, capsule, ellipsoid}, sphere-sphere, sphere-capsule,
# capsule-capsule
ROUND_SCENE = """<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="s1" pos="0 0 0.1"><freejoint/>
      <geom type="sphere" size="0.1"/></body>
    <body name="s2" pos="0.15 0.05 0.12"><freejoint/>
      <geom type="sphere" size="0.08"/></body>
    <body name="c1" pos="0.1 0.2 0.06" euler="0 90 0"><freejoint/>
      <geom type="capsule" size="0.05 0.2"/></body>
    <body name="c2" pos="0.15 0.25 0.12" euler="90 0 30"><freejoint/>
      <geom type="capsule" size="0.04 0.15"/></body>
  </worldbody>
</mujoco>"""

ELLIPSOID_SCENE = """<mujoco>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="e" pos="0 0 0.1"><freejoint/>
      <geom type="ellipsoid" size="0.1 0.15 0.08"/></body>
  </worldbody>
</mujoco>"""

SCENES = {"boxes": BOX_SCENE, "round": ROUND_SCENE,
          "ellipsoid": ELLIPSOID_SCENE, "humanoid": tp.HUMANOID_XML,
          "ant": tp.ANT_XML}


def _states(jm, name, seed):
    """qpos float32 (B, nq): free bodies jittered in position and
    orientation around their placement (env 0 exactly at it), or the
    humanoid dropped near the floor with random limbs."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(jm.qpos0, np.float64), (B, 1))
    if name == "humanoid":
        qpos[:, 2] = rng.uniform(0.1, 0.6, size=B)
        quat = np.array([1.0, 0, 0, 0]) + 0.6 * rng.normal(size=(B, 4))
        qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
        lo, hi = np.asarray(jm.jnt_range[1:]).T
        qpos[:, 7:] = rng.uniform(lo, hi, size=(B, len(lo)))
        return qpos.astype(np.float32)
    for a in range(0, jm.nq, 7):               # free joints only
        pos = 0.02 * rng.normal(size=(B, 3))
        quat = np.array([1.0, 0, 0, 0]) + 0.15 * rng.normal(size=(B, 4))
        pos[0], quat[0] = 0.0, [1.0, 0, 0, 0]
        qpos[:, a:a + 3] += pos
        q = qpos[:, a + 3:a + 7]
        qpos[:, a + 3:a + 7] = np.stack([
            quat[:, 0] * q[:, 0] - np.sum(quat[:, 1:] * q[:, 1:], 1),
            *(quat[:, 0:1] * q[:, 1:] + q[:, 0:1] * quat[:, 1:]
              + np.cross(quat[:, 1:], q[:, 1:])).T], 1)
        qpos[:, a + 3:a + 7] /= np.linalg.norm(qpos[:, a + 3:a + 7], axis=1,
                                               keepdims=True)
    return qpos.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _collided(name):
    """(name, jax model, torch model, JAX collide outputs, torch collide
    outputs)."""
    jm = tp.jax_scene(SCENES[name])
    physics = tp.jax_module("vnl_tpu.physics")
    jcol = tp.jax_module("vnl_tpu.physics.collision")
    qpos = _states(jm, name, seed=21)
    d = jax.vmap(lambda q: physics.kinematics(
        jm, physics.make_data(jm, qpos=q)))(jnp.asarray(qpos))
    jout = jax.jit(jax.vmap(lambda x: jcol.collide(jm, x)[:3]))(d)
    tm = tp.torch_model(jm)
    td = tp.data_to_torch(d)
    tout = tcol.collide(tm, td)
    return name, jm, tm, jout, tout


@pytest.fixture(scope="module", params=["boxes", "round", "ellipsoid",
                                        "humanoid"])
def collided(request):
    return _collided(request.param)


def test_pair_types_present(collided):
    name, jm, tm, _, tout = collided
    gt = np.asarray(jm.geom_type)
    kinds = {(int(a), int(b)) for a, b in zip(gt[jm.pair_geom1],
                                              gt[jm.pair_geom2])}
    G = tcol.GeomType
    want = {"boxes": {(G.PLANE, G.CYLINDER), (G.PLANE, G.BOX),
                      (G.PLANE, G.SPHERE), (G.SPHERE, G.BOX),
                      (G.BOX, G.BOX)},
            "round": {(G.PLANE, G.SPHERE), (G.PLANE, G.CAPSULE),
                      (G.SPHERE, G.SPHERE), (G.SPHERE, G.CAPSULE),
                      (G.CAPSULE, G.CAPSULE)},
            "ellipsoid": {(G.PLANE, G.ELLIPSOID)},
            "humanoid": {(G.PLANE, G.SPHERE), (G.PLANE, G.CAPSULE),
                         (G.SPHERE, G.SPHERE), (G.SPHERE, G.CAPSULE),
                         (G.CAPSULE, G.CAPSULE)}}[name]
    assert kinds == {(int(a), int(b)) for a, b in want}
    # some contacts are active, so the comparison is not only of far pairs
    assert bool((tout[0] < 0).any())


def _deepest_slots(jm):
    """Per plane-box or box-box candidate pair, the slots of its kept
    points; and the mask of every other slot."""
    jcol = tp.jax_module("vnl_tpu.physics.collision")
    con_pair = jcol.pair_expansion(jm)
    gt = np.asarray(jm.geom_type)
    t2 = gt[np.asarray(jm.pair_geom2)[con_pair]]
    kept = t2 == tcol.GeomType.BOX
    kept &= gt[np.asarray(jm.pair_geom1)[con_pair]] != tcol.GeomType.SPHERE
    groups = [np.nonzero(kept & (con_pair == p))[0]
              for p in np.unique(con_pair[kept])]
    return groups, ~kept


def _assert_same_sets(tdist, tpos, jdist, jpos, name):
    """Each port point (dist, pos) matched one to one with a JAX point."""
    for b in range(tdist.shape[0]):
        free = list(range(tdist.shape[1]))
        for i in range(tdist.shape[1]):
            err = [max(abs(tdist[b, i] - jdist[b, j]),
                       np.abs(tpos[b, i] - jpos[b, j]).max()) for j in free]
            j = int(np.argmin(err))
            assert err[j] <= 2e-5, (name, b, i, err[j])
            free.pop(j)


@pytest.mark.parametrize("field", ["dist", "pos", "frame"])
def test_collide_matches(collided, field):
    name, jm, _, jout, tout = collided
    k = ("dist", "pos", "frame").index(field)
    groups, direct = _deepest_slots(jm)
    tp.assert_close(tout[k][:, direct], np.asarray(jout[k])[:, direct], 0.0,
                    2e-5, f"{name} {field}")
    for slots in groups:
        if field == "frame":        # one frame per pair: slot for slot
            tp.assert_close(tout[2][:, slots],
                            np.asarray(jout[2])[:, slots], 0.0, 2e-5,
                            f"{name} frame")
        else:
            _assert_same_sets(tout[0][:, slots].numpy(),
                              tout[1][:, slots].numpy(),
                              np.asarray(jout[0])[:, slots],
                              np.asarray(jout[1])[:, slots], name)
        # exact ties (env 0 lies flat) keep the JAX slots
        tp.assert_close(tout[k][0, slots], np.asarray(jout[k])[0, slots],
                        0.0, 2e-5, f"{name} {field} flat")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pair_expansion_matches(name):
    jm = tp.jax_scene(SCENES[name])
    jcol = tp.jax_module("vnl_tpu.physics.collision")
    got = tcol.pair_expansion(tp.torch_model(jm))
    np.testing.assert_array_equal(got, jcol.pair_expansion(jm))
    assert len(got) == jm.ncon_max


def test_flat_box_corner_ties():
    """Env 0 of the box scene sits exactly flat: the 4 plane-box points
    and the 8 box-box points are tied corners and must land in the same
    slots as in the JAX package (checked above) and be the bottom ones."""
    _, jm, tm, _, tout = _collided("boxes")
    con_pair = tcol.pair_expansion(tm)
    gt = np.asarray(jm.geom_type)
    box_box = np.nonzero(gt[jm.pair_geom1[con_pair]] == tcol.GeomType.BOX)[0]
    assert len(box_box) == 8
    z = tout[1][0, box_box, 2]
    # box1's top face is at z = 0.16: every kept point lies on it
    torch.testing.assert_close(z, torch.full_like(z, 0.16), rtol=0,
                               atol=0.02)


def test_collide_on_torch_kinematics():
    """The port's own kinematics feeds the same contacts (humanoid)."""
    jm = tp.jax_scene(tp.HUMANOID_XML)
    physics = tp.jax_module("vnl_tpu.physics")
    jcol = tp.jax_module("vnl_tpu.physics.collision")
    qpos = _states(jm, "humanoid", seed=22)
    d = jax.vmap(lambda q: physics.kinematics(
        jm, physics.make_data(jm, qpos=q)))(jnp.asarray(qpos))
    jdist = jax.jit(jax.vmap(lambda x: jcol.collide(jm, x)[0]))(d)
    tm = tp.torch_model(jm)
    from vnl_tpu_torch.physics.forward import make_data
    td = tkin.kinematics(tm, make_data(tm, B, qpos=torch.as_tensor(qpos)))
    tp.assert_close(tcol.collide(tm, td)[0], jdist, 0.0, 5e-5, "dist")


def test_forward_on_box_scene():
    """The new pairs through constraints and the CG solve (kernel B's plain
    version; the scene has no limit row, so the solve takes the inert
    one): forward() against the JAX package's at the forward tolerance,
    qacc rtol = atol = 5e-3 (tests/test_pallas_cg.py:173-174).  CG runs
    to convergence (40 iterations): the stacked boxes' stiff contacts
    make a few iterations' iterate move with float32 rounding.

    Env 0 of _states (boxes exactly flat, face on face) is left out: lowered
    together, the 8 + 8 corners all lie at distance 0 to within rounding,
    more than the 8 kept, and the two float32 computations keep different
    ones (the SAT manifold's selection is ill-posed there, in the JAX
    package itself); its tie order at exact zero is checked above."""
    from vnl_tpu_torch.physics import forward as tfwd
    jm = tp.jax_scene(BOX_SCENE, solver="cg", iterations=40,
                      ls_iterations=10)
    qpos = _states(jm, "boxes", seed=23)[1:]
    qpos[:, 2::7] -= 0.003                     # every body a little down
    qvel = np.zeros((B - 1, jm.nv), np.float32)
    d = tp.jax_forward(jm, qpos, qvel)
    tm = tp.torch_model(jm)
    td = tfwd.forward(tm, tfwd.make_data(tm, B - 1,
                                         qpos=torch.as_tensor(qpos),
                                         qvel=torch.as_tensor(qvel)))
    assert jm.nlimit == 0 and bool((td.contact_dist < 0).any())
    tp.assert_close(td.qacc, d.qacc, 5e-3, 5e-3, "qacc")
