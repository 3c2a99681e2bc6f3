"""Shared helpers of the parity tests between vnl_tpu (JAX on the CPU) and
vnl_tpu_torch (PyTorch on the CPU): inputs are made with numpy from a seed
and handed to both as numpy arrays."""

from __future__ import annotations

import dataclasses
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tools import export_torch_assets as exporter
from vnl_tpu import mjcf
from vnl_tpu_torch import compat
from vnl_tpu_torch.physics.model import Data as TData

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN_XML = os.path.join(ROOT, "vnl_tpu_torch", "assets", "rodent_twin.xml")

# tests/test_physics.py:221 _BOX_SCENE
BOX_SCENE = """<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <geom name="base" type="box" size="1 1 0.1" pos="0 0 0.1"/>
    <body name="b" pos="{pos}" euler="{euler}">
      <freejoint/>
      <geom name="top" type="{gtype}" size="{size}" density="300"/>
    </body>
  </worldbody>
</mujoco>"""

# tests/test_pallas_cg.py:132 contact-only box (CG, nlimit == 0)
CONTACT_BOX = """<mujoco>
  <option timestep="0.005" solver="CG" iterations="8" ls_iterations="8"/>
  <worldbody>
    <geom name="base" type="box" size="1 1 0.1" pos="0 0 0.1"/>
    <body name="b" pos="0 0 0.27">
      <freejoint/>
      <geom name="top" type="box" size="0.1 0.12 0.08" density="300"/>
    </body>
  </worldbody>
</mujoco>"""


# the box scene with a damped hinged child: the Pallas position kernel needs
# at least one pointer-doubling round, and a tree whose only joint is free
# has none (vnl_tpu/ops/pallas_position.py:154 indexes jumps[0])
BOX_CHAIN = """<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <geom name="base" type="box" size="1 1 0.1" pos="0 0 0.1"/>
    <body name="b" pos="0 0 0.5">
      <freejoint/>
      <geom name="top" type="box" size="0.1 0.12 0.08" density="300"/>
      <body name="arm" pos="0.1 0 0">
        <joint name="hinge" type="hinge" axis="0 1 0" damping="0.05"
               armature="0.01"/>
        <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.03"
              contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
</mujoco>"""


def jax_module(name):
    """A vnl_tpu submodule by dotted name (vnl_tpu.physics re-exports
    functions under its submodules' names)."""
    return importlib.import_module(name)


@functools.lru_cache(maxsize=None)
def jax_twin():
    return mjcf.load_model(TWIN_XML, **exporter.TWIN_COMPILE)


@functools.lru_cache(maxsize=None)
def jax_box(gtype="box", size="0.1 0.12 0.08", pos="0 0 0.5",
            euler="0 0 0", **overrides):
    xml = BOX_SCENE.format(gtype=gtype, size=size, pos=pos, euler=euler)
    return mjcf.load_model(xml, overrides=overrides or None)


@functools.lru_cache(maxsize=None)
def jax_box_chain():
    return mjcf.load_model(BOX_CHAIN)


def torch_model(jm):
    """The torch Model of a compiled vnl_tpu Model, on the CPU."""
    return compat.model_from_numpy(exporter.model_to_numpy(jm), device="cpu")


def to_torch(x):
    return torch.as_tensor(np.array(x, dtype=np.float32))


def data_to_torch(d) -> TData:
    """A batched vnl_tpu Data as a torch Data (same field names)."""
    return TData(**{f.name: to_torch(getattr(d, f.name))
                    for f in dataclasses.fields(TData)})


def perturbed_states(jm, batch, seed, press=0.0, joint_scale=0.08,
                     vel_scale=0.5):
    """(qpos, qvel) float32 numpy: qpos0 with noisy hinges (and root
    pressed down by ``press``), random velocities."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(jm.qpos0, np.float64), (batch, 1))
    qpos[:, 2] -= press
    qpos[:, 7:] += joint_scale * rng.normal(size=(batch, jm.nq - 7))
    qvel = vel_scale * rng.normal(size=(batch, jm.nv))
    return qpos.astype(np.float32), qvel.astype(np.float32)


def jax_forward(jm, qpos, qvel):
    physics = jax_module("vnl_tpu.physics")
    d = jax.vmap(lambda q, v: physics.make_data(jm, qpos=q, qvel=v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    return jax.jit(jax.vmap(lambda x: physics.forward(jm, x)))(d)


def assert_close(got, want, rtol, atol, name=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)

