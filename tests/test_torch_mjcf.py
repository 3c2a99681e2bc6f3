"""The MJCF compiler of vnl_tpu_torch against vnl_tpu's, field by field.

For each scene the port's ``compile_numpy(load_spec(...))`` is held against
``tools/export_torch_assets.py model_to_numpy`` of ``vnl_tpu.mjcf.
load_model(...)`` under the same arguments: the same field names, dtypes
and shapes, and every field bit for bit (floats included: both compilers
work in float64 and cast to float32 once, at the end).  Scenes: the rodent
twin under the twin's compile arguments, the three small scenes of the
exporter, the inline scenes of tests/test_physics.py and
tests/test_pallas_cg.py, gymnasium's ant and humanoid and dm_control's
humanoid from site-packages.  Also: the port's compile of the twin equals
the committed rodent_twin_model.npz bit for bit, and ``load_model`` puts
those fields on a torch Model."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from tools import export_torch_assets as exporter
from vnl_tpu import mjcf as jmjcf
from vnl_tpu_torch import compat
from vnl_tpu_torch import mjcf as tmjcf

import torch_parity as tp

# tests/test_physics.py:294 _CYL_SCENE (lying on its side)
CYL_SCENE = """<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1" friction="0.8"/>
    <body name="b" pos="0 0 0.3" euler="90 0 0">
      <freejoint/>
      <geom name="cyl" type="cylinder" size="0.08 0.15" density="300"/>
    </body>
  </worldbody>
</mujoco>"""

# tests/test_physics.py:268 (a 2-link chain, implicit integrator)
CHAIN_SCENE = """<mujoco><option timestep="0.01" integrator="implicit"/>
  <worldbody><body pos="0 0 1">
    <joint name="j1" type="hinge" axis="0 1 0" damping="0.3"/>
    <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.02"
          density="1000"/>
    <body pos="0.4 0 0">
      <joint name="j2" type="hinge" axis="0 1 0" damping="0.3"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.02"
            density="1000"/>
    </body>
  </body></worldbody></mujoco>"""

# tests/test_physics.py:368 (elliptic cone, a sphere on a plane)
ELLIPTIC_SCENE = """<mujoco>
  <option cone="elliptic" impratio="4" timestep="0.005"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1" friction="0.8"/>
    <body pos="0 0 0.095"><freejoint/>
      <geom type="sphere" size="0.1" density="1000" friction="0.8"/>
    </body>
  </worldbody>
</mujoco>"""


def _site_xml(module, rel):
    spec = importlib.util.find_spec(module)
    if spec is None:
        return None
    path = os.path.join(os.path.dirname(spec.origin), rel)
    return path if os.path.exists(path) else None


SCENES = {
    "twin": (tp.TWIN_XML, exporter.TWIN_COMPILE),
    "box_chain": (exporter.BOX_CHAIN, {}),
    "ball_arm": (exporter.BALL_ARM, {}),
    "star96": (exporter.star_xml(), {}),
    "box": (tp.BOX_SCENE.format(gtype="box", size="0.1 0.12 0.08",
                                pos="0 0 0.5", euler="0 0 0"), {}),
    "box_sphere_tilted": (tp.BOX_SCENE.format(gtype="sphere", size="0.1",
                                              pos="0 0 0.3",
                                              euler="30 10 0"),
                          {"solver": "cg"}),
    "contact_box": (tp.CONTACT_BOX, {}),
    "cylinder": (CYL_SCENE, {}),
    "chain": (CHAIN_SCENE, {}),
    "elliptic": (ELLIPTIC_SCENE, {}),
    "gym_ant": (_site_xml("gymnasium", "envs/mujoco/assets/ant.xml"), {}),
    "gym_humanoid": (_site_xml("gymnasium",
                               "envs/mujoco/assets/humanoid.xml"), {}),
    "dm_humanoid": (_site_xml("dm_control", "suite/humanoid.xml"), {}),
}


def _kwargs(kw):
    """Compile arguments: the twin's as given; for the other scenes a bare
    option dict is an ``overrides`` of the options."""
    if "rescale" in kw:
        return kw
    return {"overrides": kw} if kw else {}


def assert_fields_equal(got, want):
    assert sorted(got) == sorted(want), set(got) ^ set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (k, g.dtype, w.dtype, g.shape, w.shape)
        if w.dtype.kind in "US":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_compile_matches_jax_bit_for_bit(scene):
    xml, kw = SCENES[scene]
    if xml is None:
        pytest.skip(f"{scene}: the package with this MJCF is not installed")
    kw = _kwargs(kw)
    want = exporter.model_to_numpy(jmjcf.load_model(xml, **kw))
    got = tmjcf.compile_numpy(tmjcf.load_spec(xml, **kw))
    assert_fields_equal(got, want)


def test_twin_compile_equals_committed_npz():
    got = tmjcf.compile_numpy(tmjcf.load_spec(tp.TWIN_XML,
                                              **exporter.TWIN_COMPILE))
    with np.load(compat.TWIN_MODEL) as z:
        want = {k: z[k] for k in z.files}
    assert_fields_equal(got, want)


def test_load_model_gives_the_npz_model():
    m = tmjcf.load_model(tp.TWIN_XML, device="cpu", **exporter.TWIN_COMPILE)
    ref = compat.model_from_numpy(compat.TWIN_MODEL, device="cpu")
    assert (m.nq, m.nv, m.nu, m.nbody, m.ncon_max, m.nlimit) == \
        (74, 73, 30, 65, 23, 67)
    assert m.opt == ref.opt and m.body_names == ref.body_names
    for name in ("body_pos", "dof_invweight0", "geom_size", "jnt_range",
                 "actuator_gainprm", "actuator_ctrllimited"):
        assert torch.equal(getattr(m, name), getattr(ref, name)), name
    np.testing.assert_array_equal(m.dof_ancestor_mask, ref.dof_ancestor_mask)


def test_replicate_and_defaults_expand_alike():
    """<replicate> and nested default classes (parser paths the scenes
    above leave out) compile to the same fields."""
    xml = """<mujoco>
      <default>
        <joint damping="0.1"/>
        <default class="stiff"><joint damping="2" armature="0.01"/></default>
      </default>
      <worldbody>
        <geom name="floor" type="plane" size="1 1 .1"/>
        <replicate count="3" offset="0.3 0 0" euler="0 0 20">
          <body name="arm" pos="0 0 0.2">
            <joint name="hinge" class="stiff" axis="0 1 0"/>
            <geom name="link" type="capsule" fromto="0 0 0 0.1 0 0"
                  size="0.02"/>
          </body>
        </replicate>
      </worldbody>
      <actuator><motor joint="hinge" gear="3"/></actuator>
    </mujoco>"""
    want = exporter.model_to_numpy(jmjcf.load_model(xml))
    got = tmjcf.compile_numpy(tmjcf.load_spec(xml))
    assert_fields_equal(got, want)
    assert int(got["nu"]) == 3 and int(got["nbody"]) == 4
