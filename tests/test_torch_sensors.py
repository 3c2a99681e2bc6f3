"""Sensors of vnl_tpu_torch against vnl_tpu's on dm_control's humanoid
(22 sensors, 30 sensordata: subtreelinvel, accelerometer, velocimeter and
gyro of the torso, and 18 touch sites; its force and torque sensors are
skipped by both compilers), feet pressed into the floor.

- sensors() on the same Data (the JAX package's forward output, converted):
  the same formulas in float32, rtol 1e-4 / atol 1e-4.
- forward(compute_sensors=True) end to end: velocity sensors at 1e-4; the
  accelerometer reads qacc and the touch sensors sum contact forces, so
  those are held at the forward tolerance of qacc and qfrc_constraint
  (rtol 5e-3, atol 5e-2; tests/test_pallas_cg.py:173-177).  The CG solve
  runs to convergence (50 iterations), as in tests/test_torch_newton.py:
  a few iterations leave contact forces that move with float32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu_torch.physics import forward as tfwd
from vnl_tpu_torch.physics import sensor as tsensor
from vnl_tpu_torch.physics.model import SensorType

import torch_parity as tp

B = 4


@pytest.fixture(scope="module")
def humanoid():
    jm = tp.jax_scene(tp.HUMANOID_XML, solver="cg", iterations=50,
                      ls_iterations=10)
    qpos, qvel = tp.perturbed_states(jm, B, seed=17, press=0.22,
                                     joint_scale=0.2, vel_scale=0.5)
    physics = tp.jax_module("vnl_tpu.physics")
    d = jax.jit(jax.vmap(lambda q, v: physics.forward(
        jm, physics.make_data(jm, qpos=q, qvel=v), compute_sensors=True)))(
            jnp.asarray(qpos), jnp.asarray(qvel))
    return jm, tp.torch_model(jm), qpos, qvel, d


def _slices(tm, kinds):
    cols = []
    for i in range(tm.nsensor):
        if SensorType(int(tm.sensor_type[i])) in kinds:
            a = int(tm.sensor_adr[i])
            cols += list(range(a, a + int(tm.sensor_dim[i])))
    return np.asarray(cols)


VEL = (SensorType.GYRO, SensorType.VELOCIMETER, SensorType.SUBTREELINVEL)
FORCE = (SensorType.ACCELEROMETER, SensorType.TOUCH)


def test_layout(humanoid):
    jm, tm, *_ = humanoid
    assert (tm.nsensor, tm.nsensordata) == (22, 30)
    assert len(_slices(tm, VEL)) + len(_slices(tm, FORCE)) == 30
    assert tfwd.make_data(tm, 2).sensordata.shape == (2, 30)


def test_sensors_on_same_data(humanoid):
    jm, tm, _, _, d = humanoid
    got = tsensor.sensors(tm, tp.data_to_torch(d))
    tp.assert_close(got, d.sensordata, 1e-4, 1e-4, "sensordata")
    touch = got[:, _slices(tm, (SensorType.TOUCH,))]
    assert bool((touch > 0).any()), "no touch sensor fired"


def test_forward_computes_sensors(humanoid):
    jm, tm, qpos, qvel, d = humanoid
    td = tfwd.forward(tm, tfwd.make_data(tm, B, qpos=torch.as_tensor(qpos),
                                         qvel=torch.as_tensor(qvel)),
                      compute_sensors=True)
    want = np.asarray(d.sensordata)
    vel, force = _slices(tm, VEL), _slices(tm, FORCE)
    tp.assert_close(td.sensordata[:, vel], want[:, vel], 1e-4, 1e-4,
                    "velocity sensors")
    tp.assert_close(td.sensordata[:, force], want[:, force], 5e-3, 5e-2,
                    "accelerometer and touch")


def test_sensors_off_by_default(humanoid):
    _, tm, qpos, qvel, _ = humanoid
    td = tfwd.forward(tm, tfwd.make_data(tm, B, qpos=torch.as_tensor(qpos),
                                         qvel=torch.as_tensor(qvel)))
    assert not bool(td.sensordata.any())
