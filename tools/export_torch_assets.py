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
- keeper_13fcbe84_policy.npz: the policy params and observation
  normalizer of the 230M keeper checkpoint.

Run on the CPU from the repo root:  python tools/export_torch_assets.py
The output is deterministic (fixed seeds), so a rerun rewrites the same
files.
"""

from __future__ import annotations

import dataclasses
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
            continue
        elif isinstance(v, tuple) and (not v or isinstance(v[0], str)):
            out[f.name] = np.asarray(v, dtype=np.str_)
        else:
            out[f.name] = np.asarray(v)
    return out


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
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                out[key] = np.asarray(v, np.float32)

    walk(state["params"]["policy"]["params"], "")
    out["normalizer.mean"] = np.asarray(state["normalizer_params"]["mean"])
    out["normalizer.std"] = np.asarray(state["normalizer_params"]["std"])
    return out


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from vnl_tpu import mjcf
    from vnl_tpu.data.pipeline import process_recording

    os.makedirs(ASSETS, exist_ok=True)
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
