"""Writes the numpy assets that the PyTorch port (vnl_tpu_torch) runs on.

The port imports nothing of vnl_tpu, so everything it needs from the JAX
package is carried across as plain numpy files under
vnl_tpu_torch/assets/:

- rodent_twin.xml: a generated MJCF with the rodent's widths and names
  (free root + 67 limited, damped hinges with armature, 65 bodies incl.
  world, 30 motors, capsule/sphere/ellipsoid geoms that collide only with
  the floor).  It stands in for rodent.xml until that file is in the repo.
- rodent_twin_model.npz: every field of the vnl_tpu compile of the twin
  with the options of envs/rodent.py:71-82, plus Option and the dims.
- rodent_twin_clip.npz: a 250-frame ReferenceClip made from a smooth qpos
  trajectory inside the joint ranges (data/pipeline.py process_recording).
- box_chain_model.npz, ball_arm_model.npz, star96_model.npz: the compiles
  of three small scenes (nv = 7 with a damped hinge; nv = 7 with plane
  contacts and a joint limit; nv = 96 undamped) for the kernels' tests.
- keeper_13fcbe84_policy.npz: the policy params and observation
  normalizer of the 230M keeper checkpoint.

Run on the CPU from the repo root:  python tools/export_torch_assets.py
The output is deterministic (fixed seeds), so a rerun rewrites the same
files.

  python tools/export_torch_assets.py --checkpoint <jax_ckpt> <out.npz>

flattens a JAX full-state checkpoint (an Orbax directory or a .msgpack
file) into the port's checkpoint layout, which
``vnl_tpu_torch.training.checkpoint.restore`` and the ``train.
restore_checkpoint`` option of ``python -m vnl_tpu_torch.train`` read.

  python tools/export_torch_assets.py --goldens

writes the goldens of ``python -m vnl_tpu_torch.check_numerics`` under
vnl_tpu_torch/assets/goldens/: rollouts and forward passes of vnl_tpu on
the CPU (see ``export_goldens``).

  python tools/export_torch_assets.py --benchmark-humanoid

writes benchmark/reference/assets/humanoid_model.npz: the vnl_tpu compile
of the committed dm_control suite humanoid with the humanoid envs' solver
options (HUMANOID_COMPILE), which the benchmark's plain reference runs.

  python tools/export_torch_assets.py --benchmark-cmu

writes benchmark/reference/assets/cmu_humanoid_model.npz: the compile of
the committed CMU humanoid scene (tools/export_cmu_humanoid.py) with the
same options, by vnl_tpu_torch's compiler, since vnl_tpu's has no
narrowphase for its ellipsoid pairs (tests/test_torch_cmu_humanoid.py
holds that compile against MuJoCo's).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
ASSETS = os.path.join(ROOT, "vnl_tpu_torch", "assets")
KEEPER = os.path.join(ROOT, "checkpoints_keep", "13fcbe84", "state_230809600")

# envs/rodent.py:71-82
TWIN_COMPILE = dict(rescale=(0.9, 0.9), torque_actuators=True,
                    overrides={"solver": "cg", "iterations": 6,
                               "ls_iterations": 6, "cone": "pyramidal"})
SEED = 1234

# the suite humanoid as vnl_tpu_torch/envs/humanoid.py compiles it
HUMANOID_XML = os.path.join(ASSETS, "dm_humanoid", "humanoid.xml")
HUMANOID_COMPILE = dict(overrides={"solver": "cg", "iterations": 6,
                                   "ls_iterations": 6})
BENCHMARK_HUMANOID = os.path.join(ROOT, "benchmark", "reference", "assets",
                                  "humanoid_model.npz")
# the CMU humanoid, compiled the same way by the port's compiler
CMU_XML = os.path.join(ASSETS, "dm_cmu_humanoid", "cmu_humanoid.xml")
BENCHMARK_CMU = os.path.join(ROOT, "benchmark", "reference", "assets",
                             "cmu_humanoid_model.npz")

# joints that carry a motor: the 33 tracked joints of configs/env_config.yaml
# minus three head/finger joints, so nu = 30 like the keeper's action head
_UNACTUATED = ("vertebra_axis_twist", "atlas", "finger_R")


def _body_table():
    """(name, parent, pos, [(joint, axis, range)], geom, collides) rows in
    tree order; lengths in metres before the 0.9 rescale."""
    X, Y, Z = "1 0 0", "0 1 0", "0 0 1"
    rows = []

    def add(name, parent, pos, joints, geom, collides=False):
        rows.append((name, parent, pos, joints, geom, collides))

    add("torso", "world", (0, 0, 0.08), "free",
        'type="ellipsoid" size="0.03 0.018 0.015"', True)
    # lumbar spine, backwards from the torso
    parent = "torso"
    for k in range(1, 7):
        joints = [(f"vertebra_{k}_extend", Y, (-0.3, 0.3))]
        if k == 1:
            joints.append(("vertebra_1_bend", Z, (-0.3, 0.3)))
        add(f"vertebra_{k}", parent, (-0.02 if k == 1 else -0.008, 0, 0),
            joints, 'type="capsule" fromto="0 0 0 -0.008 0 0" size="0.008"')
        parent = f"vertebra_{k}"
    add("pelvis", parent, (-0.008, 0, 0), [],
        'type="ellipsoid" size="0.015 0.015 0.012"', True)
    for s, sy in (("L", 1), ("R", -1)):
        add(f"upper_leg_{s}", "pelvis", (0, 0.015 * sy, -0.005),
            [(f"hip_{s}_supinate", X, (-0.4, 0.4)),
             (f"hip_{s}_abduct", Z, (-0.4, 0.4)),
             (f"hip_{s}_extend", Y, (-0.9, 0.6))],
            'type="capsule" fromto="0 0 0 0 0 -0.035" size="0.005"')
        add(f"lower_leg_{s}", f"upper_leg_{s}", (0, 0, -0.035),
            [(f"knee_{s}", Y, (-0.2, 1.2))],
            'type="capsule" fromto="0 0 0 0 0 -0.035" size="0.004"', True)
        add(f"foot_{s}", f"lower_leg_{s}", (0, 0, -0.035),
            [(f"ankle_{s}", Y, (-0.6, 0.6))],
            'type="capsule" fromto="0 0 0 0.015 0 0" size="0.004"', True)
        add(f"toe_{s}", f"foot_{s}", (0.015, 0, 0),
            [(f"toe_{s}", Y, (-0.5, 0.5))],
            'type="sphere" size="0.004"', True)
    for s, sy in (("L", 1), ("R", -1)):
        add(f"scapula_{s}", "torso", (0.02, 0.012 * sy, 0),
            [(f"scapula_{s}_supinate", X, (-0.3, 0.3)),
             (f"scapula_{s}_abduct", Z, (-0.3, 0.3)),
             (f"scapula_{s}_extend", Y, (-0.5, 0.5))],
            'type="capsule" fromto="0 0 0 0 0 -0.01" size="0.004"')
        add(f"upper_arm_{s}", f"scapula_{s}", (0, 0, -0.01),
            [(f"shoulder_{s}", Y, (-0.8, 0.8)),
             (f"shoulder_sup_{s}", X, (-0.4, 0.4))],
            'type="capsule" fromto="0 0 0 0 0 -0.03" size="0.004"')
        add(f"lower_arm_{s}", f"upper_arm_{s}", (0, 0, -0.03),
            [(f"elbow_{s}", Y, (-1.2, 0.2))],
            'type="capsule" fromto="0 0 0 0 0 -0.035" size="0.0035"', True)
        add(f"hand_{s}", f"lower_arm_{s}", (0, 0, -0.035),
            [(f"wrist_{s}", Y, (-0.6, 0.6))],
            'type="ellipsoid" size="0.006 0.004 0.003"', True)
        add(f"finger_{s}", f"hand_{s}", (0.006, 0, 0),
            [(f"finger_{s}", Y, (-0.5, 0.5))],
            'type="sphere" size="0.003"', True)
    # neck and head, forwards from the torso
    add("vertebra_C11", "torso", (0.03, 0, 0.005),
        [("vertebra_C11_extend", Y, (-0.4, 0.4)),
         ("vertebra_C11_bend", Z, (-0.4, 0.4))],
        'type="capsule" fromto="0 0 0 0.008 0 0" size="0.006"')
    add("vertebra_cervical_1", "vertebra_C11", (0.008, 0, 0),
        [("vertebra_cervical_1_bend", Z, (-0.4, 0.4))],
        'type="capsule" fromto="0 0 0 0.008 0 0" size="0.005"')
    add("vertebra_axis", "vertebra_cervical_1", (0.008, 0, 0),
        [("vertebra_axis_twist", X, (-0.4, 0.4))],
        'type="capsule" fromto="0 0 0 0.008 0 0" size="0.005"')
    add("skull", "vertebra_axis", (0.008, 0, 0),
        [("atlas", Y, (-0.5, 0.5))],
        'type="ellipsoid" pos="0.01 0 0" size="0.015 0.01 0.01"', True)
    add("jaw", "skull", (0.005, 0, -0.008),
        [("mandible", Y, (-0.3, 0.1))],
        'type="capsule" fromto="0 0 0 0.015 0 0" size="0.003"', True)
    for name, pos in (("ear_L", (0.004, 0.008, 0.008)),
                      ("ear_R", (0.004, -0.008, 0.008)),
                      ("eye_L", (0.015, 0.006, 0.004)),
                      ("eye_R", (0.015, -0.006, 0.004)),
                      ("nose", (0.026, 0, 0))):
        add(name, "skull", pos, [], 'type="sphere" size="0.002"')
    add("sternum", "torso", (0.01, 0, -0.012), [],
        'type="sphere" size="0.004"')
    # tail, backwards from the pelvis; alternating extend / bend
    parent = "pelvis"
    for k in range(1, 27):
        axis, kind = (Y, "extend") if k % 2 else (Z, "bend")
        r = 0.003 - 0.00006 * k
        add(f"caudal_{k}", parent, (-0.012 if k == 1 else -0.008, 0, 0),
            [(f"caudal_{k}_{kind}", axis, (-0.3, 0.3))],
            f'type="capsule" fromto="0 0 0 -0.008 0 0" size="{r:.5f}"')
        parent = f"caudal_{k}"
    add("tail_tip", parent, (-0.008, 0, 0), [], 'type="sphere" size="0.0015"')
    return rows


def twin_xml() -> str:
    """The rodent twin's MJCF.  Joint damping/armature and the motors'
    force limits are drawn from a fixed seed so every hinge differs."""
    rng = np.random.default_rng(SEED)
    rows = _body_table()
    children = {}
    for row in rows:
        children.setdefault(row[1], []).append(row)
    out = io.StringIO()
    out.write('<mujoco model="rodent_twin">\n'
              '  <compiler angle="radian"/>\n'
              '  <option timestep="0.002" solver="CG" iterations="6" '
              'ls_iterations="6"/>\n'
              '  <worldbody>\n'
              '    <geom name="floor" type="plane" size="2 2 0.1" '
              'contype="1" conaffinity="0"/>\n')
    hinge_names = []

    def emit(row, depth):
        name, _, pos, joints, geom, collides = row
        pad = "  " * depth
        out.write(f'{pad}<body name="{name}" pos="{pos[0]} {pos[1]} '
                  f'{pos[2]}">\n')
        if joints == "free":
            out.write(f'{pad}  <freejoint name="root"/>\n')
        else:
            for jname, axis, (lo, hi) in joints:
                damping = rng.uniform(0.003, 0.008)
                armature = rng.uniform(0.5e-5, 2e-5)
                out.write(f'{pad}  <joint name="{jname}" type="hinge" '
                          f'axis="{axis}" limited="true" range="{lo} {hi}" '
                          f'damping="{damping:.6f}" '
                          f'armature="{armature:.8f}"/>\n')
                hinge_names.append(jname)
        aff = "1" if collides else "0"
        out.write(f'{pad}  <geom name="{name}_geom" {geom} contype="0" '
                  f'conaffinity="{aff}"/>\n')
        for child in children.get(name, []):
            emit(child, depth + 1)
        out.write(f'{pad}</body>\n')

    for row in children["world"]:
        emit(row, 2)
    out.write('  </worldbody>\n  <actuator>\n')
    for jname in hinge_names:
        if jname in _TRACKED_JOINTS and jname not in _UNACTUATED:
            f = rng.uniform(0.02, 0.04)
            out.write(f'    <motor name="{jname}" joint="{jname}" gear="1" '
                      f'ctrllimited="true" ctrlrange="-1 1" '
                      f'forcelimited="true" forcerange="{-f:.5f} {f:.5f}"/>\n')
    out.write('  </actuator>\n</mujoco>\n')
    return out.getvalue()


def _env_config():
    import yaml
    with open(os.path.join(ROOT, "configs", "env_config.yaml")) as f:
        return yaml.safe_load(f)["env"]["env_args"]


_TRACKED_JOINTS = tuple(_env_config()["joint_names"])


def model_to_numpy(m) -> dict:
    """Every field of a compiled vnl_tpu Model as numpy arrays: sizes as
    0-d ints, Option fields as ``opt_<name>``, names as unicode arrays."""
    out = {}
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if f.name == "opt":
            for g in dataclasses.fields(v):
                out[f"opt_{g.name}"] = np.asarray(getattr(v, g.name))
        elif f.name == "skin_file":
            if v is not None:      # left out for a model without a skin
                out[f.name] = np.asarray(v, dtype=np.str_)
        elif isinstance(v, tuple) and (not v or isinstance(v[0], str)):
            out[f.name] = np.asarray(v, dtype=np.str_)
        else:
            out[f.name] = np.asarray(v)
    return out


def _flat(tree, prefix: str, out: dict) -> dict:
    """``prefix.a.b.c`` keys of the leaves of a nested dict."""
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            _flat(v, key, out)
        else:
            out[key] = np.asarray(v)
    return out


def training_state_to_numpy(state) -> dict:
    """A JAX TrainingState (the trainer's, or the nested dict an Orbax or
    msgpack restore without a target gives) in the port's checkpoint layout
    (vnl_tpu_torch/compat.py): ``params.<net>.<flax key>``,
    ``optimizer.count`` and ``optimizer.{mu,nu}.<net>.<flax key>`` (optax
    adam's ScaleByAdamState; the schedule's count is the same number),
    ``normalizer.<field>`` and ``env_steps``."""
    from flax import serialization
    if not isinstance(state, dict):
        state = serialization.to_state_dict(state)
    opt = state["optimizer_state"]
    adam = opt[0] if isinstance(opt, (list, tuple)) else opt["0"]
    out = {"env_steps": np.asarray(int(np.asarray(state["env_steps"])),
                                   np.int64),
           "optimizer.count": np.asarray(int(np.asarray(adam["count"])),
                                         np.int64)}
    for net in ("policy", "value"):
        _flat(state["params"][net]["params"], f"params.{net}", out)
        for moment in ("mu", "nu"):
            _flat(adam[moment][net]["params"], f"optimizer.{moment}.{net}",
                  out)
    _flat(state["normalizer_params"], "normalizer", out)
    return {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
            for k, v in out.items()}


def read_jax_checkpoint(path: str) -> dict:
    """A JAX full-state checkpoint (an Orbax directory or a ``.msgpack``
    file of vnl_tpu/training/checkpoint.py) as a nested dict."""
    if os.path.isdir(path):
        import orbax.checkpoint as ocp
        return ocp.StandardCheckpointer().restore(os.path.abspath(path))
    from flax import serialization
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def twin_clip_qpos(m, n_frames: int = 250, dt: float = 0.02) -> np.ndarray:
    """A smooth (n_frames, nq) trajectory: slow forward drift and yaw sway
    of the root, each hinge a sinusoid inside its range."""
    rng = np.random.default_rng(SEED + 1)
    t = np.arange(n_frames) * dt
    q0 = np.asarray(m.qpos0, np.float64)
    qpos = np.tile(q0, (n_frames, 1))
    qpos[:, 0] += 0.02 * t
    qpos[:, 1] += 0.003 * np.sin(0.7 * t)
    qpos[:, 2] += 0.002 * np.sin(1.3 * t)
    yaw = 0.1 * np.sin(0.5 * t)
    qpos[:, 3:7] = np.stack([np.cos(yaw / 2), 0 * t, 0 * t,
                             np.sin(yaw / 2)], -1)
    rng_lo, rng_hi = np.asarray(m.jnt_range, np.float64)[1:].T
    mid, half = 0.5 * (rng_lo + rng_hi), 0.5 * (rng_hi - rng_lo)
    freq = rng.uniform(0.4, 1.5, m.nq - 7)
    phase = rng.uniform(0, 2 * np.pi, m.nq - 7)
    qpos[:, 7:] = mid + 0.4 * half * np.sin(2 * np.pi * freq * t[:, None]
                                           + phase)
    return qpos.astype(np.float32)


def keeper_policy() -> dict:
    """Policy params + normalizer of the keeper (an Orbax TrainingState
    directory), flattened to ``a.b.c`` keys."""
    import orbax.checkpoint as ocp
    state = ocp.StandardCheckpointer().restore(KEEPER)
    out = {k: v.astype(np.float32) for k, v in
           _flat(state["params"]["policy"]["params"], "", {}).items()}
    out["normalizer.mean"] = np.asarray(state["normalizer_params"]["mean"])
    out["normalizer.std"] = np.asarray(state["normalizer_params"]["std"])
    return out


# the box scene with a damped hinged child (nv = 7): the smallest model the
# kernels are tried on.  The child is there because the Pallas position
# kernel needs at least one pointer-doubling round, and a tree whose only
# joint is free has none (vnl_tpu/ops/pallas_position.py:154 indexes
# jumps[0]).
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


# a ball with a limited, damped hinged arm on a plane (nv = 7, three
# plane contacts, one limit row): the smallest constraint system the CG
# kernel is tried on
BALL_ARM = """<mujoco>
  <option timestep="0.002" solver="CG" iterations="6" ls_iterations="6"
          cone="pyramidal"/>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1"/>
    <body name="ball" pos="0 0 0.05">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.05" density="500"/>
      <body name="arm" pos="0.05 0 0">
        <joint name="elbow" type="hinge" axis="0 1 0" range="-0.3 0.3"
               limited="true" damping="0.02" armature="0.005"/>
        <geom name="arm" type="capsule" fromto="0 0 0 0.15 0 0" size="0.02"
              density="500"/>
      </body>
    </body>
  </worldbody>
</mujoco>"""


def star_xml(n_hinges: int = 90) -> str:
    """A free ball with ``n_hinges`` undamped hinged spokes (nv = 6 +
    n_hinges; 96 is the widest matrix kernel A's register tiles cover):
    shallow, so its mass matrix stays well conditioned in float32."""
    spokes = []
    for i in range(n_hinges):
        a = 2.0 * np.pi * i / n_hinges
        z = 0.05 * ((i % 5) - 2) / 2.0
        x, y = 0.06 * np.cos(a), 0.06 * np.sin(a)
        axis = ("0 0 1", "1 0 0", "0 1 0")[i % 3]
        spokes.append(
            f'      <body name="s{i}" pos="{x:.5f} {y:.5f} {z:.5f}">\n'
            f'        <joint name="j{i}" type="hinge" axis="{axis}" '
            f'armature="0.001"/>\n'
            f'        <geom type="capsule" fromto="0 0 0 {x / 2:.5f} '
            f'{y / 2:.5f} 0.01" size="0.004" contype="0" '
            f'conaffinity="0"/>\n'
            f'      </body>')
    return ('<mujoco>\n  <option timestep="0.002"/>\n  <worldbody>\n'
            '    <geom name="base" type="plane" size="1 1 0.1"/>\n'
            '    <body name="hub" pos="0 0 0.3">\n      <freejoint/>\n'
            '      <geom name="ball" type="sphere" size="0.05"/>\n'
            + "\n".join(spokes)
            + '\n    </body>\n  </worldbody>\n</mujoco>\n')


SMALL_SCENES = {"box_chain": lambda: BOX_CHAIN, "ball_arm": lambda: BALL_ARM,
                "star96": star_xml}


def small_scene(name: str):
    """The vnl_tpu compile of one of SMALL_SCENES."""
    from vnl_tpu import mjcf
    return mjcf.load_model(SMALL_SCENES[name]())


def export_small_scenes():
    """<name>_model.npz of every small scene, for the tests that run the
    kernels on the card without the JAX package."""
    for name in SMALL_SCENES:
        np.savez_compressed(os.path.join(ASSETS, f"{name}_model.npz"),
                            **model_to_numpy(small_scene(name)))


def export_checkpoint(src: str, dst: str) -> int:
    """Flattens the JAX checkpoint ``src`` into the port's ``dst`` .npz."""
    state = training_state_to_numpy(read_jax_checkpoint(src))
    with open(dst, "wb") as f:
        np.savez(f, **state)
    print(f"{dst}: env_steps {int(state['env_steps'])}, Adam count "
          f"{int(state['optimizer.count'])}, {len(state)} arrays")
    return 0


# ---------------------------------------------------------------------------
# goldens of python -m vnl_tpu_torch.check_numerics
# ---------------------------------------------------------------------------

GOLDENS = os.path.join(ASSETS, "goldens")
GOLDEN_SEED = 2718
GOLDEN_ENVS = 16
GOLDEN_STEPS = 20
FORWARD_STATES = 128
# rollout golden -> (scene, scale of the N(0, 1) actions; None: the
# keeper's deterministic policy drives the env).  0.2 is the scale of
# tests/test_golden.py _rodent_rollout, 0.3 that of its ant _rollout.
ROLLOUT_GOLDENS = {"twin_actions": ("twin", 0.2),
                   "twin_keeper": ("twin", None),
                   "humanoid_actions": ("humanoid", 0.2),
                   "ant_actions": ("ant", 0.3)}
FORWARD_SCENES = ("twin", "humanoid", "ant")
_SCENE_SEEDS = {"twin": 1, "humanoid": 2, "ant": 3}
# What vnl_tpu runs here, recorded in every golden: off a TPU its Pallas
# kernels are off (ops/pallas_position.enabled(), ops/pallas_cg.enabled()),
# so a control step inverts the mass matrix exactly on its first substep
# and refines the carried inverses on the other four (envs/base.py:114-125),
# and the constraint solve is the XLA one.  forward() inverts exactly.
POSITION_STAGE = ("vnl_tpu on the CPU: the unfused position stage; env "
                  "steps refine the carried inverses on substeps 2-5")


@contextlib.contextmanager
def committed_scenes():
    """vnl_tpu's humanoid and ant envs read the module constants
    _HUMANOID_XML and _ANT_XML (absent reference files): point them at the
    scenes committed for the port while an env is built."""
    from vnl_tpu.envs import ant, humanoid
    old = humanoid._HUMANOID_XML, ant._ANT_XML
    humanoid._HUMANOID_XML = os.path.join(ASSETS, "dm_humanoid",
                                          "humanoid.xml")
    ant._ANT_XML = os.path.join(ASSETS, "gym_ant.xml")
    try:
        yield
    finally:
        humanoid._HUMANOID_XML, ant._ANT_XML = old


@functools.lru_cache(maxsize=None)
def golden_env(scene: str):
    """The vnl_tpu env of a golden's scene: RodentTracking on the twin and
    its clip with the env_args of vnl_tpu_torch/configs/
    rodent_twin_config.yaml, HumanoidTracking and AntTracking on the
    committed scenes with their defaults."""
    if scene != "twin":
        from vnl_tpu.envs.ant import AntTracking
        from vnl_tpu.envs.humanoid import HumanoidTracking
        with committed_scenes():
            return HumanoidTracking() if scene == "humanoid" else AntTracking()
    import jax.numpy as jnp
    import yaml
    from vnl_tpu.data.reference_clip import ReferenceClip
    from vnl_tpu.envs.rodent import RodentTracking
    with open(os.path.join(ROOT, "vnl_tpu_torch", "configs",
                           "rodent_twin_config.yaml")) as f:
        env = yaml.safe_load(f)["env"]
    args = dict(env["env_args"])
    args["mjcf_path"] = os.path.join(ROOT, args["mjcf_path"])
    with np.load(os.path.join(ROOT, env["clip_path"])) as z:
        clip = ReferenceClip(**{k: jnp.asarray(z[k]) for k in z.files})
    return RodentTracking(clip, **args)


def golden_inputs(name: str) -> dict:
    """The numpy draws of a rollout golden for all GOLDEN_ENVS envs:
    ``start_frame``, ``noise`` (the twin's scaled qpos noise; the humanoid
    and ant envs add none) and ``actions`` (not for the keeper).  Every
    golden of a scene starts from the same states."""
    scene, scale = ROLLOUT_GOLDENS[name]
    env = golden_env(scene)
    n = GOLDEN_ENVS
    rng = np.random.default_rng((GOLDEN_SEED, _SCENE_SEEDS[scene]))
    out = {}
    if scene == "twin":
        # frames whose steps and reference window stay inside the clip
        hi = env._clip_length - GOLDEN_STEPS - env._ref_traj_length
        out["start_frame"] = rng.integers(0, hi, n).astype(np.int32)
        out["noise"] = (env._reset_noise_scale * rng.standard_normal(
            (n, env.sys.nq))).astype(np.float32)
    elif scene == "humanoid":
        # the range of the JAX draw (envs/humanoid.py:92)
        hi = env._clip_length - env._episode_length - env._ref_traj_length
        out["start_frame"] = rng.integers(0, hi, n).astype(np.int32)
    else:
        out["start_frame"] = np.zeros(n, np.int32)   # envs/ant.py:89
    if scale is not None:
        rng = np.random.default_rng((GOLDEN_SEED, _SCENE_SEEDS[scene], 1))
        out["actions"] = (scale * rng.standard_normal(
            (GOLDEN_STEPS, n, env.action_size))).astype(np.float32)
    return out


def _rodent_reset(env, start_frame, noise):
    """vnl_tpu's RodentTracking.reset (envs/rodent.py:145-190, no
    min_sub_clip_length) with the start frame and the scaled qpos noise
    given instead of drawn; ``_check_rodent_reset`` holds it to the
    env's own reset."""
    import jax.numpy as jnp
    from vnl_tpu.envs.base import State
    info = {"cur_frame": start_frame,
            "sub_clip_frame": jnp.zeros((), jnp.int32),
            "sub_clip_length": jnp.asarray(env._sub_clip_length, jnp.int32)}
    ref = env._get_clip(info)
    qpos = jnp.concatenate([ref.position[start_frame],
                            ref.quaternion[start_frame],
                            ref.joints[start_frame]])
    qvel = jnp.concatenate([ref.velocity[start_frame],
                            ref.angular_velocity[start_frame],
                            ref.joints_velocity[start_frame]])
    data = env.pipeline_init(qpos + noise, qvel)
    info["traj"] = env._get_traj(data, start_frame, ref)
    obs = env._get_obs(data, jnp.zeros(env.sys.nu), info)
    reward, done, zero = jnp.zeros(3)
    metrics = {k: zero for k in ("rcom", "rvel", "rtrunk", "rquat", "ract",
                                 "rapp", "termination_error")}
    state = State(data, obs, reward, done, metrics, info)
    info["termination_error"] = env._calculate_termination(state, ref)
    return state.replace(info=info)


def _strong(tree):
    """The leaves as strongly typed arrays (a weakly typed leaf would make
    the jitted step compile a second time)."""
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)),
                                  tree)


def _jax_reset(scene, start_frame, noise):
    import jax
    import jax.numpy as jnp
    env = golden_env(scene)
    frame = jnp.asarray(start_frame, jnp.int32)
    if scene != "twin":
        return _strong(jax.jit(jax.vmap(env.reset_to_frame))(frame))
    reset = jax.jit(jax.vmap(functools.partial(_rodent_reset, env)))
    return _strong(reset(frame, jnp.asarray(noise)))


def _check_rodent_reset():
    """``_rodent_reset`` fed the draws of vnl_tpu's own reset (as
    tests/test_torch_rodent_env.py reads them) equals that reset: qpos and
    qvel within a float32 rounding (the jitted reset may fuse the noise's
    scaling into its addition to qpos, one rounding fewer), what the env
    reads from them within 1e-5, the frame counters exactly."""
    import jax
    env = golden_env("twin")
    keys = jax.random.split(jax.random.PRNGKey(GOLDEN_SEED), 2)
    want = jax.jit(jax.vmap(env.reset))(keys)
    frames, noises = [], []
    for k in keys:
        rng_frame, rng_noise, _, _ = jax.random.split(k, 4)
        frames.append(jax.random.randint(
            rng_frame, (), 0, env._clip_length - env._sub_clip_length
            - env._ref_traj_length))
        noises.append(env._reset_noise_scale * jax.random.normal(
            rng_noise, (env.sys.nq,)))
    got = _jax_reset("twin", np.stack(frames), np.stack(noises))
    for k in ("qpos", "qvel"):
        np.testing.assert_allclose(
            np.asarray(getattr(got.pipeline_state, k)),
            np.asarray(getattr(want.pipeline_state, k)), rtol=1e-6,
            atol=1e-7, err_msg=k)
    for k, v in dict(want.info, obs=want.obs).items():
        g = np.asarray(got.obs if k == "obs" else got.info[k])
        np.testing.assert_allclose(g, np.asarray(v), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_step(scene: str):
    import jax
    return jax.jit(jax.vmap(golden_env(scene).step))


@functools.lru_cache(maxsize=None)
def jax_keeper():
    """vnl_tpu's deterministic policy of the keeper
    (keeper_13fcbe84_policy.npz): ``make_inference_fn(net)(params,
    deterministic=True)``, jitted.  It still draws the intention latent
    from its key (models/ppo_networks.py:40-43, models/intention.py:54);
    ``keeper_latent`` gives that draw."""
    import jax
    import jax.numpy as jnp
    from vnl_tpu import models
    from vnl_tpu.training import running_statistics as rs
    with np.load(os.path.join(ASSETS, "keeper_13fcbe84_policy.npz")) as z:
        flat = {k: z[k] for k in z.files}
    mean, std = flat.pop("normalizer.mean"), flat.pop("normalizer.std")
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)

    def widths(stack):
        return tuple(flat[f"{stack}.proj_{i}.bias"].shape[0]
                     for i in range(len(tree[stack]) // 2))

    net = models.make_intention_ppo_networks(
        flat["encoder.proj_0.kernel"].shape[0], mean.shape[0],
        flat["action_head.bias"].shape[0] // 2,
        intention_latent_size=flat["post_mean.bias"].shape[0],
        encoder_layer_sizes=widths("encoder"),
        decoder_layer_sizes=widths("decoder"),
        preprocess_observations_fn=rs.normalize)
    norm = rs.RunningStatisticsState(
        count=jnp.zeros(()), mean=jnp.asarray(mean),
        summed_variance=jnp.zeros_like(jnp.asarray(mean)),
        std=jnp.asarray(std))
    policy = models.make_inference_fn(net)((norm, {"params": tree}),
                                           deterministic=True)
    return jax.jit(policy), flat["post_mean.bias"].shape[0]


def keeper_key(t: int):
    import jax
    return jax.random.fold_in(jax.random.PRNGKey(GOLDEN_SEED), t)


def keeper_latent(t: int, n: int) -> np.ndarray:
    """The standard-normal intention draw of the keeper's policy at step
    ``t`` for ``n`` envs: the key's second half, one draw of the latent's
    shape (models/ppo_networks.py:41, models/intention.py:54)."""
    import jax
    import jax.numpy as jnp
    _, net_rng = jax.random.split(keeper_key(t))
    return np.asarray(jax.random.normal(net_rng, (n, jax_keeper()[1]),
                                        jnp.float32))


def jax_rollout(name: str, n_envs: int = GOLDEN_ENVS,
                n_steps: int = GOLDEN_STEPS, ulp: bool = False) -> dict:
    """The raw vnl_tpu env (no wrappers, no auto-reset; ``env.step`` as
    tests/test_golden.py _rodent_rollout calls it, vmapped) over the first
    ``n_envs`` envs and ``n_steps`` control steps of a rollout golden.
    Arrays (n_steps + 1, n_envs, ...): row 0 is the reset.  ``ulp``:
    start from the reset's qpos moved up by one float32 ulp."""
    import jax.numpy as jnp
    scene, scale = ROLLOUT_GOLDENS[name]
    inp = golden_inputs(name)
    noise = inp.get("noise")
    state = _jax_reset(scene, inp["start_frame"][:n_envs],
                       None if noise is None else noise[:n_envs])
    if ulp:
        qpos = np.nextafter(np.asarray(state.pipeline_state.qpos),
                            np.float32(np.inf))
        state = state.replace(pipeline_state=state.pipeline_state.replace(
            qpos=jnp.asarray(qpos)))
    step = _jax_step(scene)
    rec = {k: [] for k in ("qpos", "qvel", "obs", "reward", "done")}
    actions, latent = [], []

    def record(s):
        for k in ("qpos", "qvel"):
            rec[k].append(np.asarray(getattr(s.pipeline_state, k)))
        for k in ("obs", "reward", "done"):
            rec[k].append(np.asarray(getattr(s, k)))

    record(state)
    for t in range(n_steps):
        if scale is None:
            a, _ = jax_keeper()[0](state.info["traj"], state.obs,
                                   keeper_key(t))
            actions.append(np.asarray(a))
            latent.append(keeper_latent(t, n_envs))
        else:
            a = inp["actions"][t, :n_envs]
        state = _strong(step(state, jnp.asarray(a)))
        record(state)
    out = {k: np.stack(v).astype(np.float32) for k, v in rec.items()}
    if scale is None:
        out["actions"] = np.stack(actions).astype(np.float32)
        out["latent_noise"] = np.stack(latent).astype(np.float32)
    return out


def rollout_golden(name: str) -> dict:
    """A rollout golden: its inputs, the rollout and ``spread`` (n_steps +
    1,), each step's largest |qpos - qpos'| over the envs, qpos' from the
    same rollout started one float32 ulp up."""
    out = dict(golden_inputs(name), **jax_rollout(name))
    moved = jax_rollout(name, ulp=True)
    out["spread"] = np.abs(moved["qpos"] - out["qpos"]).max(
        axis=(1, 2)).astype(np.float32)
    out["scene"] = np.asarray(ROLLOUT_GOLDENS[name][0])
    out["position_stage"] = np.asarray(POSITION_STAGE)
    return out


def forward_inputs(scene: str, n: int = FORWARD_STATES):
    """(qpos, qvel) float32 as tools/check_tpu_numerics.py:64-66 makes
    them: qpos0 with the root 5 mm down and the joints moved by 0.05 N(0,
    1), qvel 0.3 N(0, 1); numpy draws."""
    m = golden_env(scene).sys
    rng = np.random.default_rng((GOLDEN_SEED, _SCENE_SEEDS[scene], 2))
    qpos = np.tile(np.asarray(m.qpos0, np.float32), (n, 1))
    qpos[:, 2] -= np.float32(0.005)
    qpos[:, 7:] += (0.05 * rng.standard_normal((n, m.nq - 7))).astype(
        np.float32)
    qvel = (0.3 * rng.standard_normal((n, m.nv))).astype(np.float32)
    return qpos, qvel


def jax_forward(scene: str, qpos, qvel) -> dict:
    """qacc and qfrc_constraint of vnl_tpu.physics.forward on a batch."""
    import importlib
    import jax
    import jax.numpy as jnp
    physics = importlib.import_module("vnl_tpu.physics")
    m = golden_env(scene).sys
    d = jax.vmap(lambda q, v: physics.make_data(m, qpos=q, qvel=v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    d = jax.jit(jax.vmap(lambda x: physics.forward(m, x)))(d)
    return {k: np.asarray(getattr(d, k), np.float32)
            for k in ("qacc", "qfrc_constraint")}


def forward_golden(scene: str) -> dict:
    qpos, qvel = forward_inputs(scene)
    return dict(qpos=qpos, qvel=qvel, **jax_forward(scene, qpos, qvel),
                scene=np.asarray(scene),
                position_stage=np.asarray(POSITION_STAGE))


def export_goldens():
    """vnl_tpu_torch/assets/goldens/<name>.npz: the four rollout goldens
    (GOLDEN_ENVS envs, GOLDEN_STEPS control steps) and forward_<scene> for
    the three scenes (FORWARD_STATES states), float32, from numpy seeds."""
    os.makedirs(GOLDENS, exist_ok=True)
    _check_rodent_reset()
    files = {name: rollout_golden(name) for name in ROLLOUT_GOLDENS}
    files.update({f"forward_{s}": forward_golden(s) for s in FORWARD_SCENES})
    total = 0
    for name, arrays in files.items():
        path = os.path.join(GOLDENS, f"{name}.npz")
        np.savez_compressed(path, **arrays)
        total += os.path.getsize(path)
        extra = (" spread " + " ".join(f"{x:.1e}" for x in arrays["spread"])
                 if "spread" in arrays else "")
        print(f"{name}: {os.path.getsize(path)} bytes{extra}")
    print(f"goldens: {total} bytes")
    return 0


def cmu_model_numpy() -> dict:
    """The port's compile of the CMU humanoid scene, as BENCHMARK_CMU
    holds it."""
    from vnl_tpu_torch import mjcf as torch_mjcf
    return torch_mjcf.compile_numpy(torch_mjcf.load_spec(CMU_XML,
                                                         **HUMANOID_COMPILE))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--benchmark-cmu"]:
        np.savez(BENCHMARK_CMU, **cmu_model_numpy())
        print(f"{BENCHMARK_CMU}: {os.path.getsize(BENCHMARK_CMU)} bytes")
        return 0
    import jax
    jax.config.update("jax_platforms", "cpu")
    if argv[:1] == ["--checkpoint"]:
        if len(argv) != 3:
            raise SystemExit("usage: export_torch_assets.py --checkpoint "
                             "<jax checkpoint> <out.npz>")
        return export_checkpoint(argv[1], argv[2])
    if argv[:1] == ["--goldens"]:
        return export_goldens()
    from vnl_tpu import mjcf
    if argv[:1] == ["--benchmark-humanoid"]:
        np.savez(BENCHMARK_HUMANOID, **model_to_numpy(
            mjcf.load_model(HUMANOID_XML, **HUMANOID_COMPILE)))
        print(f"{BENCHMARK_HUMANOID}: "
              f"{os.path.getsize(BENCHMARK_HUMANOID)} bytes")
        return 0
    from vnl_tpu.data.pipeline import process_recording

    os.makedirs(ASSETS, exist_ok=True)
    export_small_scenes()
    xml = twin_xml()
    xml_path = os.path.join(ASSETS, "rodent_twin.xml")
    with open(xml_path, "w") as f:
        f.write(xml)

    m = mjcf.load_model(xml_path, **TWIN_COMPILE)
    cfg = _env_config()
    assert (m.nq, m.nv, m.nu) == (74, 73, 30), (m.nq, m.nv, m.nu)
    for n in cfg["walker_body_names"] + ["hand_L", "hand_R", "skull"]:
        assert n in m.body_names, n
    for n in cfg["joint_names"]:
        assert n in m.joint_names, n
    obs = m.nq + m.nv + m.nv + 3 * len(cfg["end_eff_names"])
    window = cfg["ref_traj_length"]
    traj = window * (3 * len(cfg["appendage_names"])
                     + 2 * 3 * len(cfg["walker_body_names"]) + 3
                     + len(cfg["joint_names"]))
    assert (obs, traj) == (232, 795), (obs, traj)
    np.savez(os.path.join(ASSETS, "rodent_twin_model.npz"),
             **model_to_numpy(m))

    lib = process_recording(m, twin_clip_qpos(m), clip_length=250)
    clip = jax.tree_util.tree_map(lambda x: np.asarray(x[0]), lib.clips)
    np.savez(os.path.join(ASSETS, "rodent_twin_clip.npz"),
             **{f.name: getattr(clip, f.name)
                for f in dataclasses.fields(clip)
                if getattr(clip, f.name) is not None})

    pol = keeper_policy()
    np.savez(os.path.join(ASSETS, "keeper_13fcbe84_policy.npz"), **pol)
    print(f"nbody {m.nbody} njnt {m.njnt} ngeom {m.ngeom} nq {m.nq} "
          f"nv {m.nv} nu {m.nu} ncon_max {m.ncon_max} nlimit {m.nlimit} "
          f"obs {obs} traj {traj}; policy tensors {len(pol)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
