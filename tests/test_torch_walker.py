"""vnl_tpu_torch.envs.walker.RatWalker against vnl_tpu.envs.walker on the
rodent twin (which has the skull and the tracked names): every property
and method gives the same value exactly, or raises the same error with the
same message.  The egocentric camera is the port's batched camera
(tests/test_torch_render.py holds it against vnl_tpu's)."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from vnl_tpu.envs import walker as jwalker
from vnl_tpu_torch.envs import walker as twalker
from vnl_tpu_torch.render import make_egocentric_camera


@pytest.fixture(scope="module")
def walkers():
    jm = tp.jax_twin()
    tm = tp.torch_model(jm)
    return jwalker.RatWalker(jm), twalker.RatWalker(tm)


def outcome(fn):
    try:
        return "value", fn()
    except Exception as e:  # the error itself is what is compared
        return "error", (type(e), str(e))


def assert_same(got, want):
    assert got[0] == want[0], (got, want)
    g, w = got[1], want[1]
    if isinstance(w, np.ndarray):
        assert isinstance(g, np.ndarray) and g.shape == w.shape
        assert g.dtype.kind == w.dtype.kind and np.array_equal(g, w)
    else:
        assert g == w


def test_name_tables_are_the_jax_packages():
    assert twalker.RAT_MOCAP_JOINTS == jwalker.RAT_MOCAP_JOINTS
    assert twalker.END_EFFECTOR_BODIES == jwalker.END_EFFECTOR_BODIES
    assert twalker._MOCAP_EXCLUDE.pattern == jwalker._MOCAP_EXCLUDE.pattern


@pytest.mark.parametrize("name", [
    "mocap_joint_order", "mocap_tracking_bodies", "observable_joints",
    "end_effectors", "joint_actuator_order", "env_config"])
def test_properties_match(walkers, name):
    jw, tw = walkers
    call = (lambda w: w.env_config()) if name == "env_config" else \
        (lambda w: getattr(w, name))
    assert_same(outcome(lambda: call(tw)), outcome(lambda: call(jw)))


def test_index_maps_match_and_raise_alike(walkers):
    jw, tw = walkers
    joints = list(tw.model.joint_names[1:6]) + [tw.model.joint_names[-1]]
    bodies = ["skull", "torso", tw.model.body_names[3]]
    for fn in (lambda w: w.hinge_index(joints),
               lambda w: w.body_index(bodies),
               lambda w: w.hinge_index(joints + ["no_such_joint"]),
               lambda w: w.body_index(["no_such_body"])):
        assert_same(outcome(lambda: fn(tw)), outcome(lambda: fn(jw)))
    assert outcome(lambda: tw.body_index(["no_such_body"]))[0] == "error"


def test_pose_to_actuation_matches(walkers):
    jw, tw = walkers
    pose = np.random.default_rng(0).uniform(
        -0.5, 0.5, (4, len(jw.mocap_joint_order)))
    got = outcome(lambda: tw.pose_to_actuation(pose))
    want = outcome(lambda: jw.pose_to_actuation(pose))
    assert got[0] == want[0]
    if want[0] == "value":
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1] == want[1]


def test_egocentric_camera_is_the_batched_camera(walkers):
    _, tw = walkers
    jm = tp.jax_twin()
    qpos, qvel = tp.perturbed_states(jm, 2, 3, joint_scale=0.3)
    from vnl_tpu_torch.physics import forward, kinematics
    from vnl_tpu_torch.physics.model import Data
    d = kinematics.kinematics(tw.model, forward.make_data(
        tw.model, 2, torch.as_tensor(qpos), torch.as_tensor(qvel)))
    assert isinstance(d, Data)
    img = tw.egocentric_camera(32, 24)(d)
    assert img.shape == (2, 24, 32, 3) and img.dtype == torch.float32
    ref = make_egocentric_camera(tw.model, "skull", width=32, height=24)(d)
    assert torch.equal(img, ref)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
