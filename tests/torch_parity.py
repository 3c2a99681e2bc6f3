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
from vnl_tpu_torch.envs import State
from vnl_tpu_torch.physics.model import Data as TData

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN_XML = os.path.join(ROOT, "vnl_tpu_torch", "assets", "rodent_twin.xml")
HUMANOID_XML = compat.DM_HUMANOID_XML     # dm_control suite/humanoid.xml
ANT_XML = compat.GYM_ANT_XML              # gymnasium's ant.xml

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


BOX_CHAIN = exporter.BOX_CHAIN


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
def jax_scene(path, **overrides):
    """A compiled vnl_tpu model of an MJCF file or string, with option
    overrides."""
    return mjcf.load_model(path, overrides=overrides or None)


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


def rodent_state_to_torch(js) -> State:
    """A batched vnl_tpu RodentTracking State as the port's State (the
    frame counters as int64)."""
    info = {k: (torch.as_tensor(np.array(v)).long()
                if k in ("cur_frame", "sub_clip_frame", "sub_clip_length")
                else to_torch(v)) for k, v in js.info.items()}
    return State(data_to_torch(js.pipeline_state), to_torch(js.obs),
                 to_torch(js.reward), to_torch(js.done),
                 {k: to_torch(v) for k, v in js.metrics.items()}, info)


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

