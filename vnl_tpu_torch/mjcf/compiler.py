"""MJCF spec -> physics Model compiler (PyTorch counterpart of
vnl_tpu/mjcf/compiler.py).

Host-side NumPy compilation, float64 throughout, that ends in the field
dict of ``compat.model_from_numpy`` (the layout of
tools/export_torch_assets.py ``model_to_numpy``): sizes as 0-d ints,
Option fields as ``opt_<name>``, names as unicode arrays, index tables and
masks as the JAX compiler keeps them, and every float leaf cast to float32
once, at the end, as the JAX compiler casts it.  So the port's compile of
an MJCF equals the JAX package's bit for bit (tests/test_torch_mjcf.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from vnl_tpu_torch.mjcf.parser import MjcfElement, MjcfSpec, parse
from vnl_tpu_torch.physics.model import (
    BiasType, ConeType, DisableBit, DynType, GainType, GeomType,
    IntegratorType, JointType, Option, SensorType, SolverType,
)

# ---------------------------------------------------------------------------
# schema defaults (MuJoCo XML reference values)
# ---------------------------------------------------------------------------

_JOINT_DEFAULTS = {
    "type": "hinge", "pos": "0 0 0", "axis": "0 0 1", "range": "0 0",
    "limited": None, "stiffness": "0", "damping": "0", "armature": "0",
    "frictionloss": "0", "springref": "0", "ref": "0", "margin": "0",
    "solreflimit": "0.02 1", "solimplimit": "0.9 0.95 0.001 0.5 2",
}
_GEOM_DEFAULTS = {
    "type": "sphere", "pos": "0 0 0", "size": "0 0 0", "density": "1000",
    "friction": "1 0.005 0.0001", "solref": "0.02 1",
    "solimp": "0.9 0.95 0.001 0.5 2", "margin": "0", "gap": "0",
    "contype": "1", "conaffinity": "1", "condim": "3", "priority": "0",
    "solmix": "1",
}
_PAIR_DEFAULTS = {
    "condim": "3", "friction": "1 1 0.005 0.0001 0.0001",
    "solref": "0.02 1", "solimp": "0.9 0.95 0.001 0.5 2",
    "margin": "0", "gap": "0",
}
_ACT_DEFAULTS = {
    "ctrlrange": "0 0", "forcerange": "0 0", "ctrllimited": None,
    "forcelimited": None, "gear": "1", "gaintype": "fixed",
    "biastype": "none", "dyntype": "none", "gainprm": "1 0 0",
    "biasprm": "0 0 0", "dynprm": "1 0 0",
}

_GEOM_TYPES = {
    "plane": GeomType.PLANE, "sphere": GeomType.SPHERE,
    "capsule": GeomType.CAPSULE, "ellipsoid": GeomType.ELLIPSOID,
    "cylinder": GeomType.CYLINDER, "box": GeomType.BOX, "mesh": GeomType.MESH,
}
_JOINT_TYPES = {
    "free": JointType.FREE, "ball": JointType.BALL,
    "slide": JointType.SLIDE, "hinge": JointType.HINGE,
}
_JOINT_NQ = {JointType.FREE: 7, JointType.BALL: 4,
             JointType.SLIDE: 1, JointType.HINGE: 1}
_JOINT_NV = {JointType.FREE: 6, JointType.BALL: 3,
             JointType.SLIDE: 1, JointType.HINGE: 1}

# max contact points our narrowphase emits per geom-type pair
_PAIR_NCON = {
    (GeomType.PLANE, GeomType.SPHERE): 1,
    (GeomType.PLANE, GeomType.CAPSULE): 2,
    (GeomType.PLANE, GeomType.ELLIPSOID): 1,
    (GeomType.PLANE, GeomType.CYLINDER): 4,
    (GeomType.PLANE, GeomType.BOX): 4,
    (GeomType.SPHERE, GeomType.SPHERE): 1,
    (GeomType.SPHERE, GeomType.CAPSULE): 1,
    (GeomType.CAPSULE, GeomType.CAPSULE): 1,
    (GeomType.SPHERE, GeomType.BOX): 1,
    (GeomType.BOX, GeomType.BOX): 8,
    (GeomType.SPHERE, GeomType.ELLIPSOID): 1,
    (GeomType.CAPSULE, GeomType.ELLIPSOID): 1,
    (GeomType.ELLIPSOID, GeomType.ELLIPSOID): 1,
}


def _floats(s: str) -> np.ndarray:
    return np.fromstring(s, sep=" ", dtype=np.float64)


def _pad(v: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.float64)
    out[: min(len(v), n)] = v[:n] if len(v) > n else v
    return out


_SOLIMP_DEFAULT = np.array([0.9, 0.95, 0.001, 0.5, 2.0])


def _solimp(s: str) -> np.ndarray:
    """solimp may be given with 3 values; the tail keeps defaults."""
    return _fill(s, _SOLIMP_DEFAULT)


def _fill(s: str, defaults: np.ndarray) -> np.ndarray:
    """Parses a possibly-short attribute; unspecified tail keeps defaults."""
    v = _floats(s)
    out = np.asarray(defaults, dtype=np.float64).copy()
    n = min(len(v), len(out))
    out[:n] = v[:n]
    return out


class _Compiler:
    def __init__(self, spec: MjcfSpec):
        self.spec = spec
        self.degree = spec.compiler.get("angle", "degree") == "degree"
        self.eulerseq = spec.compiler.get("eulerseq", "xyz")
        self.autolimits = spec.compiler.get("autolimits", "true") == "true"
        ifg = spec.compiler.get("inertiafromgeom", "auto")
        self.inertiafromgeom = ifg  # "true" | "false" | "auto"
        # lower bounds of every body's mass and principal inertias (0: none)
        self.boundmass = float(spec.compiler.get("boundmass", "0"))
        self.boundinertia = float(spec.compiler.get("boundinertia", "0"))

        # accumulators
        self.body_name: List[str] = []
        self.body_parent: List[int] = []
        self.body_pos: List[np.ndarray] = []
        self.body_quat: List[np.ndarray] = []
        self.body_elems: List[Optional[MjcfElement]] = []
        self.jnt_name: List[str] = []
        self.jnt_body: List[int] = []
        self.jnt_elems: List[MjcfElement] = []
        self.geom_name: List[str] = []
        self.geom_body: List[int] = []
        self.geom_elems: List[MjcfElement] = []
        self.site_name: List[str] = []
        self.site_body: List[int] = []
        self.site_elems: List[MjcfElement] = []

    # -- attribute resolution ------------------------------------------------
    def res(self, el: MjcfElement, key: str, schema: Dict[str, Optional[str]]):
        tag = el.tag if el.tag != "freejoint" else "joint"
        if tag in ("motor", "general", "position", "velocity"):
            # actuator defaults share the <general> class table plus own tag
            v = self.spec.resolve(el.tag, el, key)
            if v is None and el.tag != "general":
                v = self.spec.resolve("general", el, key)
            if v is None:
                v = schema.get(key)
            return v
        v = self.spec.resolve(tag, el, key)
        if v is None:
            v = schema.get(key)
        return v

    def angle(self, x: np.ndarray) -> np.ndarray:
        return np.deg2rad(x) if self.degree else x

    def orientation(self, el: MjcfElement, schema: Dict) -> np.ndarray:
        """Resolves quat/euler/axisangle/xyaxes/zaxis to a quaternion."""
        get = lambda k: self.res(el, k, schema)
        for key in ("quat", "euler", "axisangle", "xyaxes", "zaxis"):
            v = get(key)
            if v is not None:
                arr = _floats(v)
                if key == "quat":
                    q = arr / np.linalg.norm(arr)
                elif key == "euler":
                    q = _euler_to_quat_np(self.angle(arr), self.eulerseq)
                elif key == "axisangle":
                    ax = arr[:3] / np.linalg.norm(arr[:3])
                    q = _axis_angle_quat_np(ax, self.angle(arr[3:4])[0])
                elif key == "xyaxes":
                    x = arr[:3] / np.linalg.norm(arr[:3])
                    y = arr[3:]
                    y = y - x * np.dot(x, y)
                    y /= np.linalg.norm(y)
                    z = np.cross(x, y)
                    q = _mat_to_quat_np(np.stack([x, y, z], axis=1))
                else:  # zaxis
                    z = arr / np.linalg.norm(arr)
                    q = _z_to_quat_np(z)
                return q
        return np.array([1.0, 0.0, 0.0, 0.0])

    # -- tree walk -----------------------------------------------------------
    def add_body(self, el: Optional[MjcfElement], parent: int) -> int:
        bid = len(self.body_name)
        if el is None:  # world
            self.body_name.append("world")
            self.body_pos.append(np.zeros(3))
            self.body_quat.append(np.array([1.0, 0, 0, 0]))
        else:
            self.body_name.append(el.get("name", f"body{bid}"))
            pos = _floats(el.get("pos", "0 0 0"))
            self.body_pos.append(_pad(pos, 3))
            self.body_quat.append(self.orientation(el, {}))
        self.body_parent.append(parent)
        self.body_elems.append(el)
        return bid

    def walk(self, el: MjcfElement, bid: int) -> None:
        """Two-phase DFS matching MuJoCo id assignment: bodies get DFS ids,
        but joints/geoms/sites are numbered by owning body id — a joint
        element written after its body's nested children still belongs to
        the parent body's consecutive block."""
        per_body: dict = {}

        def collect(el, bid):
            own = per_body.setdefault(bid, {"joint": [], "geom": [], "site": []})
            for child in el.children:
                if child.tag == "body":
                    cid = self.add_body(child, bid)
                    collect(child, cid)
                elif child.tag in ("joint", "freejoint"):
                    own["joint"].append(child)
                elif child.tag == "geom":
                    own["geom"].append(child)
                elif child.tag == "site":
                    own["site"].append(child)
                # cameras/lights/inertial handled elsewhere or ignored

        collect(el, bid)
        for b in range(len(self.body_name)):
            items = per_body.get(b, {"joint": [], "geom": [], "site": []})
            for child in items["joint"]:
                self.jnt_name.append(child.get("name", f"joint{len(self.jnt_name)}"))
                self.jnt_body.append(b)
                self.jnt_elems.append(child)
            for child in items["geom"]:
                self.geom_name.append(child.get("name", f"geom{len(self.geom_name)}"))
                self.geom_body.append(b)
                self.geom_elems.append(child)
            for child in items["site"]:
                self.site_name.append(child.get("name", f"site{len(self.site_name)}"))
                self.site_body.append(b)
                self.site_elems.append(child)

    # -- geom compilation ----------------------------------------------------
    def compile_geom(self, el: MjcfElement) -> Dict:
        g: Dict = {}
        gt = self.res(el, "type", _GEOM_DEFAULTS)
        g["type"] = _GEOM_TYPES[gt]
        size = _pad(_floats(self.res(el, "size", _GEOM_DEFAULTS)), 3)
        fromto = el.get("fromto") or self.spec.resolve("geom", el, "fromto")
        if fromto is not None:
            ft = _floats(fromto)
            a, b = ft[:3], ft[3:]
            mid = 0.5 * (a + b)
            d = b - a
            length = np.linalg.norm(d)
            g["pos"] = mid
            # MuJoCo's compiled frame has +z pointing from `to` to `from`
            g["quat"] = _z_to_quat_np(-d / max(length, 1e-15))
            size[1] = 0.5 * length
        else:
            g["pos"] = _pad(_floats(self.res(el, "pos", _GEOM_DEFAULTS)), 3)
            g["quat"] = self.orientation(el, _GEOM_DEFAULTS)
        g["size"] = size
        g["friction"] = _fill(self.res(el, "friction", _GEOM_DEFAULTS),
                              np.array([1.0, 0.005, 0.0001]))
        g["solref"] = _fill(self.res(el, "solref", _GEOM_DEFAULTS),
                            np.array([0.02, 1.0]))
        g["solimp"] = _solimp(self.res(el, "solimp", _GEOM_DEFAULTS))
        for k in ("margin", "gap", "density", "solmix"):
            g[k] = float(self.res(el, k, _GEOM_DEFAULTS))
        for k in ("contype", "conaffinity", "condim", "priority"):
            g[k] = int(self.res(el, k, _GEOM_DEFAULTS))
        mass = self.res(el, "mass", _GEOM_DEFAULTS)
        g["mass"] = None if mass is None else float(mass)
        return g

    # -- main ---------------------------------------------------------------
    def compile(self) -> Dict[str, np.ndarray]:
        spec = self.spec
        world = self.add_body(None, 0)
        self.walk(spec.worldbody, world)

        nbody = len(self.body_name)
        njnt = len(self.jnt_elems)
        ngeom = len(self.geom_elems)
        nsite = len(self.site_elems)

        # --- joints / dofs ---
        jnt_type = np.zeros(njnt, dtype=np.int32)
        jnt_qposadr = np.zeros(njnt, dtype=np.int32)
        jnt_dofadr = np.zeros(njnt, dtype=np.int32)
        jnt_bodyid = np.array(self.jnt_body, dtype=np.int32)
        jnt_pos = np.zeros((njnt, 3))
        jnt_axis = np.zeros((njnt, 3))
        jnt_range = np.zeros((njnt, 2))
        jnt_limited = np.zeros(njnt, dtype=bool)
        jnt_stiffness = np.zeros(njnt)
        jnt_margin = np.zeros(njnt)
        jnt_solref = np.zeros((njnt, 2))
        jnt_solimp = np.zeros((njnt, 5))
        jnt_ref = np.zeros(njnt)
        jnt_springref = np.zeros(njnt)

        nq = nv = 0
        dof_jntid: List[int] = []
        dof_bodyid: List[int] = []
        dof_armature: List[float] = []
        dof_damping: List[float] = []
        dof_frictionloss: List[float] = []
        for j, el in enumerate(self.jnt_elems):
            jt = (JointType.FREE if el.tag == "freejoint"
                  else _JOINT_TYPES[self.res(el, "type", _JOINT_DEFAULTS)])
            jnt_type[j] = int(jt)
            jnt_qposadr[j] = nq
            jnt_dofadr[j] = nv
            nq += _JOINT_NQ[jt]
            ndof = _JOINT_NV[jt]
            if el.tag == "freejoint":
                arm = damp = fl = 0.0
            else:
                arm = float(self.res(el, "armature", _JOINT_DEFAULTS))
                damp = float(self.res(el, "damping", _JOINT_DEFAULTS))
                fl = float(self.res(el, "frictionloss", _JOINT_DEFAULTS))
            for _ in range(ndof):
                dof_jntid.append(j)
                dof_bodyid.append(self.jnt_body[j])
                dof_armature.append(arm)
                dof_damping.append(damp)
                dof_frictionloss.append(fl)
            nv += ndof
            if el.tag == "freejoint":
                jnt_axis[j] = np.array([0.0, 0.0, 1.0])
                continue
            jnt_pos[j] = _pad(_floats(self.res(el, "pos", _JOINT_DEFAULTS)), 3)
            ax = _floats(self.res(el, "axis", _JOINT_DEFAULTS))
            jnt_axis[j] = ax / np.linalg.norm(ax)
            rng = _floats(self.res(el, "range", _JOINT_DEFAULTS))
            if jt in (JointType.HINGE, JointType.BALL):
                rng = self.angle(rng)
            jnt_range[j] = rng[:2]
            lim = self.res(el, "limited", _JOINT_DEFAULTS)
            if lim is None or lim == "auto":
                has_range = (self.res(el, "range", _JOINT_DEFAULTS) != "0 0")
                jnt_limited[j] = self.autolimits and has_range and jt != JointType.FREE
            else:
                jnt_limited[j] = lim == "true"
            jnt_stiffness[j] = float(self.res(el, "stiffness", _JOINT_DEFAULTS))
            jnt_margin[j] = float(self.res(el, "margin", _JOINT_DEFAULTS))
            jnt_solref[j] = _floats(self.res(el, "solreflimit", _JOINT_DEFAULTS))
            jnt_solimp[j] = _solimp(self.res(el, "solimplimit", _JOINT_DEFAULTS))
            ref = _floats(self.res(el, "ref", _JOINT_DEFAULTS))
            sref = _floats(self.res(el, "springref", _JOINT_DEFAULTS))
            if jt == JointType.HINGE:
                ref, sref = self.angle(ref), self.angle(sref)
            jnt_ref[j] = ref[0]
            jnt_springref[j] = sref[0]

        # --- body bookkeeping ---
        body_parentid = np.array(self.body_parent, dtype=np.int32)
        body_jntadr = np.full(nbody, 0, dtype=np.int32)
        body_jntnum = np.zeros(nbody, dtype=np.int32)
        body_dofadr = np.full(nbody, 0, dtype=np.int32)
        body_dofnum = np.zeros(nbody, dtype=np.int32)
        for j in range(njnt):
            b = jnt_bodyid[j]
            if body_jntnum[b] == 0:
                body_jntadr[b] = j
                body_dofadr[b] = jnt_dofadr[j]
            body_jntnum[b] += 1
            body_dofnum[b] += _JOINT_NV[JointType(jnt_type[j])]
        body_rootid = np.zeros(nbody, dtype=np.int32)
        body_depth = np.zeros(nbody, dtype=np.int32)
        for b in range(1, nbody):
            p = body_parentid[b]
            body_rootid[b] = b if p == 0 else body_rootid[p]
            body_depth[b] = body_depth[p] + 1

        # --- qpos0 / qpos_spring ---
        qpos0 = np.zeros(nq)
        qpos_spring = np.zeros(nq)
        body_pos = np.stack(self.body_pos)
        body_quat = np.stack(self.body_quat)
        for j in range(njnt):
            jt, adr = JointType(jnt_type[j]), jnt_qposadr[j]
            if jt == JointType.FREE:
                b = jnt_bodyid[j]
                qpos0[adr:adr + 3] = body_pos[b]
                qpos0[adr + 3:adr + 7] = body_quat[b]
                qpos_spring[adr:adr + 7] = qpos0[adr:adr + 7]
            elif jt == JointType.BALL:
                qpos0[adr] = 1.0
                qpos_spring[adr] = 1.0
            else:
                qpos0[adr] = jnt_ref[j]
                qpos_spring[adr] = jnt_springref[j]

        # --- geoms ---
        geoms = [self.compile_geom(el) for el in self.geom_elems]
        geom_bodyid = np.array(self.geom_body, dtype=np.int32)
        geom_type = np.array([g["type"] for g in geoms], dtype=np.int32)
        geom_pos = np.stack([g["pos"] for g in geoms]) if ngeom else np.zeros((0, 3))
        geom_quat = (np.stack([g["quat"] for g in geoms]) if ngeom
                     else np.zeros((0, 4)))
        geom_size = (np.stack([g["size"] for g in geoms]) if ngeom
                     else np.zeros((0, 3)))
        geom_friction = (np.stack([g["friction"] for g in geoms]) if ngeom
                         else np.zeros((0, 3)))
        geom_solref = (np.stack([g["solref"] for g in geoms]) if ngeom
                       else np.zeros((0, 2)))
        geom_solimp = (np.stack([g["solimp"] for g in geoms]) if ngeom
                       else np.zeros((0, 5)))
        geom_margin = np.array([g["margin"] for g in geoms])
        geom_gap = np.array([g["gap"] for g in geoms])
        geom_rbound = np.array([_rbound(g) for g in geoms])

        # --- inertia ---
        body_mass = np.zeros(nbody)
        body_ipos = np.zeros((nbody, 3))
        body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
        body_inertia = np.zeros((nbody, 3))
        for b in range(1, nbody):
            el = self.body_elems[b]
            inertial = next((c for c in el.children if c.tag == "inertial"), None)
            use_geom = (self.inertiafromgeom == "true"
                        or (self.inertiafromgeom == "auto" and inertial is None))
            if use_geom:
                gs = [(geoms[g], geom_pos[g], geom_quat[g])
                      for g in range(ngeom) if geom_bodyid[g] == b]
                m, com, itensor = _body_inertia_from_geoms(gs)
            else:
                m = float(inertial.get("mass"))
                com = _pad(_floats(inertial.get("pos", "0 0 0")), 3)
                q = self.orientation(inertial, {})
                if inertial.get("diaginertia") is not None:
                    diag = _floats(inertial.get("diaginertia"))
                    R = _quat_to_mat_np(q)
                    itensor = R @ np.diag(diag) @ R.T
                else:
                    fi = _floats(inertial.get("fullinertia"))
                    itensor = np.array([[fi[0], fi[3], fi[4]],
                                        [fi[3], fi[1], fi[5]],
                                        [fi[4], fi[5], fi[2]]])
            body_mass[b] = max(m, self.boundmass)
            body_ipos[b] = com
            diag, iq = _principal_inertia(itensor)
            body_inertia[b] = np.maximum(diag, self.boundinertia)
            body_iquat[b] = iq

        body_subtreemass = body_mass.copy()
        for b in range(nbody - 1, 0, -1):
            body_subtreemass[body_parentid[b]] += body_subtreemass[b]

        # --- sites ---
        site_pos = (np.stack([_pad(_floats(self.res(el, "pos", _GEOM_DEFAULTS)), 3)
                              for el in self.site_elems])
                    if nsite else np.zeros((0, 3)))
        site_quat = (np.stack([self.orientation(el, {}) for el in self.site_elems])
                     if nsite else np.zeros((0, 4)))
        site_bodyid = np.array(self.site_body, dtype=np.int32)
        def _site_attr(el, key, default):
            v = self.spec.resolve("site", el, key)
            return v if v is not None else default

        site_type = np.array(
            [int(_GEOM_TYPES[_site_attr(el, "type", "sphere")])
             for el in self.site_elems], dtype=np.int32)
        site_size = (np.stack([
            _fill(_site_attr(el, "size", "0.005"),
                  np.array([0.005, 0.005, 0.005]))
            for el in self.site_elems]) if nsite else np.zeros((0, 3)))

        # --- sensors ---
        _SENSOR_TYPES = {
            "touch": (SensorType.TOUCH, 1, "site"),
            "accelerometer": (SensorType.ACCELEROMETER, 3, "site"),
            "velocimeter": (SensorType.VELOCIMETER, 3, "site"),
            "gyro": (SensorType.GYRO, 3, "site"),
            "subtreelinvel": (SensorType.SUBTREELINVEL, 3, "body"),
        }
        smap = {n: i for i, n in enumerate(self.site_name)}
        bmap_s = {n: i for i, n in enumerate(self.body_name)}
        sensor_type, sensor_objid, sensor_dim, sensor_names = [], [], [], []
        for el in spec.sensors:
            if el.tag not in _SENSOR_TYPES:
                continue  # unsupported sensor kinds are skipped
            st, dim, objkind = _SENSOR_TYPES[el.tag]
            obj = smap[el.get("site")] if objkind == "site" else \
                bmap_s[el.get("body")]
            sensor_type.append(int(st))
            sensor_objid.append(obj)
            sensor_dim.append(dim)
            sensor_names.append(el.get("name", el.tag))
        sensor_type = np.array(sensor_type, dtype=np.int32)
        sensor_objid = np.array(sensor_objid, dtype=np.int32)
        sensor_dim = np.array(sensor_dim, dtype=np.int32)
        sensor_adr = np.concatenate(
            [[0], np.cumsum(sensor_dim)[:-1]]).astype(np.int32) \
            if len(sensor_dim) else np.zeros(0, np.int32)
        nsensor = len(sensor_type)
        nsensordata = int(sensor_dim.sum()) if nsensor else 0

        # --- actuators ---
        nu = len(spec.actuators)
        actuator_trnid = np.zeros(nu, dtype=np.int32)
        actuator_dyntype = np.zeros(nu, dtype=np.int32)
        actuator_gaintype = np.zeros(nu, dtype=np.int32)
        actuator_biastype = np.zeros(nu, dtype=np.int32)
        actuator_gear = np.zeros(nu)
        actuator_gainprm = np.zeros((nu, 3))
        actuator_biasprm = np.zeros((nu, 3))
        actuator_dynprm = np.zeros((nu, 1))
        actuator_ctrlrange = np.zeros((nu, 2))
        actuator_forcerange = np.zeros((nu, 2))
        actuator_ctrllimited = np.zeros(nu, dtype=bool)
        actuator_forcelimited = np.zeros(nu, dtype=bool)
        actuator_actadr = np.full(nu, -1, dtype=np.int32)
        actuator_names = []
        na = 0
        jmap = {n: i for i, n in enumerate(self.jnt_name)}
        for i, el in enumerate(spec.actuators):
            actuator_names.append(el.get("name", f"actuator{i}"))
            actuator_trnid[i] = jmap[el.get("joint")]
            if el.tag == "motor":
                dyntype, gaintype, biastype = "none", "fixed", "none"
                gainprm, biasprm, dynprm = "1 0 0", "0 0 0", "1 0 0"
            else:
                dyntype = self.res(el, "dyntype", _ACT_DEFAULTS)
                gaintype = self.res(el, "gaintype", _ACT_DEFAULTS)
                biastype = self.res(el, "biastype", _ACT_DEFAULTS)
                if el.get("_nobias") == "true":
                    biastype, biasprm = "none", "0 0 0"
                else:
                    biasprm = self.res(el, "biasprm", _ACT_DEFAULTS)
                gainprm = self.res(el, "gainprm", _ACT_DEFAULTS)
                dynprm = self.res(el, "dynprm", _ACT_DEFAULTS)
            actuator_dyntype[i] = {"none": DynType.NONE, "integrator": DynType.INTEGRATOR,
                                   "filter": DynType.FILTER,
                                   "filterexact": DynType.FILTEREXACT}[dyntype]
            actuator_gaintype[i] = {"fixed": GainType.FIXED,
                                    "affine": GainType.AFFINE}[gaintype]
            actuator_biastype[i] = {"none": BiasType.NONE,
                                    "affine": BiasType.AFFINE}[biastype]
            actuator_gainprm[i] = _pad(_floats(gainprm), 3)
            actuator_biasprm[i] = _pad(_floats(biasprm), 3)
            actuator_dynprm[i] = _pad(_floats(dynprm), 1)
            actuator_gear[i] = _floats(self.res(el, "gear", _ACT_DEFAULTS))[0]
            cr = self.res(el, "ctrlrange", _ACT_DEFAULTS)
            fr = self.res(el, "forcerange", _ACT_DEFAULTS)
            actuator_ctrlrange[i] = _floats(cr)[:2]
            actuator_forcerange[i] = _floats(fr)[:2]
            for key, arr, rng in (("ctrllimited", actuator_ctrllimited, cr),
                                  ("forcelimited", actuator_forcelimited, fr)):
                lim = self.res(el, key, _ACT_DEFAULTS)
                if lim is None or lim == "auto":
                    arr[i] = self.autolimits and rng != "0 0"
                else:
                    arr[i] = lim == "true"
            if actuator_dyntype[i] != DynType.NONE:
                actuator_actadr[i] = na
                na += 1

        # --- contact pairs ---
        gmap = {n: i for i, n in enumerate(self.geom_name)}
        bmap = {n: i for i, n in enumerate(self.body_name)}
        pairs = _make_pairs(
            spec, geoms, geom_bodyid, geom_type, body_parentid, body_jntnum,
            gmap, bmap, self)
        npair = len(pairs)
        pair_geom1 = np.array([p["g1"] for p in pairs], dtype=np.int32)
        pair_geom2 = np.array([p["g2"] for p in pairs], dtype=np.int32)
        pair_dim = np.array([p["condim"] for p in pairs], dtype=np.int32)
        pair_friction = (np.stack([p["friction"] for p in pairs])
                         if npair else np.zeros((0, 5)))
        pair_solref = (np.stack([p["solref"] for p in pairs])
                       if npair else np.zeros((0, 2)))
        pair_solimp = (np.stack([p["solimp"] for p in pairs])
                       if npair else np.zeros((0, 5)))
        pair_margin = np.array([p["margin"] for p in pairs])
        pair_gap = np.array([p["gap"] for p in pairs])
        ncon_max = int(sum(
            _PAIR_NCON[_type_key(geom_type[p["g1"]], geom_type[p["g2"]])]
            for p in pairs))

        # --- limits ---
        nlimit = int(jnt_limited.sum())

        # --- dof ancestry (for CRB mass matrix masking) ---
        dof_parent = np.full(nv, -1, dtype=np.int32)
        body_last_dof = np.full(nbody, -1, dtype=np.int32)
        for b in range(1, nbody):
            p = body_parentid[b]
            last = body_last_dof[p]
            for j in range(body_jntadr[b], body_jntadr[b] + body_jntnum[b]):
                for d in range(jnt_dofadr[j],
                               jnt_dofadr[j] + _JOINT_NV[JointType(jnt_type[j])]):
                    dof_parent[d] = last
                    last = d
            body_last_dof[b] = last
        dof_ancestor_mask = np.zeros((nv, nv), dtype=bool)
        for i in range(nv):
            d = i
            while d >= 0:
                dof_ancestor_mask[i, d] = True
                d = dof_parent[d]

        # --- tree-accumulation masks (prefix/suffix sums as matmuls) ---
        body_ancestor = np.zeros((nbody, nbody), dtype=bool)
        for b in range(nbody):
            bb = b
            while True:
                body_ancestor[b, bb] = True
                if bb == 0:
                    break
                bb = body_parentid[bb]
        body_subtree_mask = body_ancestor.T.astype(np.float64)  # c in subtree(b)
        body_chain_dof_mask = np.zeros((nbody, nv))
        for b in range(1, nbody):
            bb = b
            while bb != 0:
                a0 = body_dofadr[bb]
                body_chain_dof_mask[b, a0:a0 + body_dofnum[bb]] = 1.0
                bb = body_parentid[bb]
        # dof_prefix_mask: dofs contributing to dof i's velocity snapshot:
        # full chains of strict-ancestor bodies, earlier joints of the same
        # body, and (free-joint rotation dofs) the joint's own translations.
        dof_prefix_mask = np.zeros((nv, nv))
        for b in range(1, nbody):
            parent_chain = body_chain_dof_mask[body_parentid[b]]
            jadr, jnum = body_jntadr[b], body_jntnum[b]
            for j in range(jadr, jadr + jnum):
                jt = JointType(jnt_type[j])
                adr = jnt_dofadr[j]
                ndof = _JOINT_NV[jt]
                base = parent_chain.copy()
                # earlier joints of the same body
                for j2 in range(jadr, j):
                    a2 = jnt_dofadr[j2]
                    base[a2:a2 + _JOINT_NV[JointType(jnt_type[j2])]] = 1.0
                for k in range(ndof):
                    row = base.copy()
                    if jt == JointType.FREE and k >= 3:
                        row[adr:adr + 3] = 1.0  # translation precedes rotation
                    dof_prefix_mask[adr + k] = row

        # --- qpos0 constants (diagApprox inverse weights) ---
        from vnl_tpu_torch.mjcf import const0
        md = dict(
            nbody=nbody, nv=nv, njnt=njnt,
            body_parentid=body_parentid, body_rootid=body_rootid,
            body_pos=body_pos, body_quat=body_quat, body_ipos=body_ipos,
            body_iquat=body_iquat, body_mass=body_mass,
            body_inertia=body_inertia, body_dofadr=body_dofadr,
            body_dofnum=body_dofnum, jnt_type=jnt_type,
            jnt_bodyid=jnt_bodyid, jnt_dofadr=jnt_dofadr, jnt_pos=jnt_pos,
            jnt_axis=jnt_axis, dof_bodyid=np.array(dof_bodyid, dtype=np.int32),
            dof_armature=np.array(dof_armature),
            dof_ancestor_mask=dof_ancestor_mask,
        )
        dof_invweight0, body_invweight0, _ = const0.compute_invweight0(md)

        # --- options ---
        opt = self._compile_option()

        # --- keyframes ---
        nkey = len(spec.keyframes)
        key_qpos = np.zeros((nkey, nq))
        key_names = []
        for i, k in enumerate(spec.keyframes):
            key_names.append(k.get("name", f"key{i}"))
            kq = _floats(k.get("qpos", ""))
            key_qpos[i, :len(kq)] = kq

        arr = lambda x: np.asarray(x, dtype=np.float32)
        # the skin's path is the last field, and only a model with a skin
        # has it (as model_to_numpy writes a JAX Model)
        skin = ({} if spec.skin_file is None
                else {"skin_file": spec.skin_file})
        return _to_numpy(dict(
            nq=nq, nv=nv, nu=nu, na=na, nbody=nbody, njnt=njnt, ngeom=ngeom,
            nsite=nsite, npair=npair, ncon_max=ncon_max, nlimit=nlimit,
            nkey=nkey, nsensor=nsensor, nsensordata=nsensordata, opt=opt,
            jnt_type=jnt_type, jnt_qposadr=jnt_qposadr, jnt_dofadr=jnt_dofadr,
            jnt_bodyid=jnt_bodyid, jnt_limited=jnt_limited,
            dof_bodyid=np.array(dof_bodyid, dtype=np.int32),
            dof_jntid=np.array(dof_jntid, dtype=np.int32),
            body_parentid=body_parentid, body_rootid=body_rootid,
            body_jntadr=body_jntadr, body_jntnum=body_jntnum,
            body_dofadr=body_dofadr, body_dofnum=body_dofnum,
            body_treeid=body_depth,
            geom_bodyid=geom_bodyid, geom_type=geom_type,
            site_bodyid=site_bodyid, site_type=site_type,
            sensor_type=sensor_type, sensor_objid=sensor_objid,
            sensor_adr=sensor_adr, sensor_dim=sensor_dim,
            actuator_trnid=actuator_trnid, actuator_dyntype=actuator_dyntype,
            actuator_gaintype=actuator_gaintype,
            actuator_biastype=actuator_biastype,
            pair_geom1=pair_geom1, pair_geom2=pair_geom2, pair_dim=pair_dim,
            dof_ancestor_mask=dof_ancestor_mask,
            body_subtree_mask=body_subtree_mask,
            body_chain_dof_mask=body_chain_dof_mask,
            dof_prefix_mask=dof_prefix_mask,
            body_names=tuple(self.body_name),
            joint_names=tuple(self.jnt_name),
            geom_names=tuple(self.geom_name),
            site_names=tuple(self.site_name),
            actuator_names=tuple(actuator_names),
            sensor_names=tuple(sensor_names),
            key_names=tuple(key_names),
            qpos0=arr(qpos0), qpos_spring=arr(qpos_spring),
            body_pos=arr(body_pos), body_quat=arr(body_quat),
            body_ipos=arr(body_ipos), body_iquat=arr(body_iquat),
            body_mass=arr(body_mass), body_inertia=arr(body_inertia),
            body_subtreemass=arr(body_subtreemass),
            jnt_pos=arr(jnt_pos), jnt_axis=arr(jnt_axis),
            jnt_range=arr(jnt_range), jnt_stiffness=arr(jnt_stiffness),
            jnt_margin=arr(jnt_margin), jnt_solref=arr(jnt_solref),
            jnt_solimp=arr(jnt_solimp),
            dof_armature=arr(dof_armature), dof_damping=arr(dof_damping),
            dof_frictionloss=arr(dof_frictionloss),
            dof_invweight0=arr(dof_invweight0),
            body_invweight0=arr(body_invweight0),
            geom_pos=arr(geom_pos), geom_quat=arr(geom_quat),
            geom_size=arr(geom_size), geom_friction=arr(geom_friction),
            geom_solref=arr(geom_solref), geom_solimp=arr(geom_solimp),
            geom_margin=arr(geom_margin), geom_gap=arr(geom_gap),
            geom_rbound=arr(geom_rbound),
            site_pos=arr(site_pos), site_quat=arr(site_quat),
            site_size=arr(site_size),
            actuator_gear=arr(actuator_gear),
            actuator_gainprm=arr(actuator_gainprm),
            actuator_biasprm=arr(actuator_biasprm),
            actuator_dynprm=arr(actuator_dynprm),
            actuator_ctrlrange=arr(actuator_ctrlrange),
            actuator_forcerange=arr(actuator_forcerange),
            actuator_ctrllimited=np.asarray(actuator_ctrllimited),
            actuator_forcelimited=np.asarray(actuator_forcelimited),
            actuator_actadr=np.asarray(actuator_actadr),
            pair_friction=arr(pair_friction), pair_solref=arr(pair_solref),
            pair_solimp=arr(pair_solimp), pair_margin=arr(pair_margin),
            pair_gap=arr(pair_gap), key_qpos=arr(key_qpos), **skin,
        ))

    def _compile_option(self) -> Option:
        o = self.spec.option
        fl = self.spec.option_flags
        solver = {"pgs": SolverType.PGS, "cg": SolverType.CG,
                  "newton": SolverType.NEWTON}[o.get("solver", "Newton").lower()]
        cone = {"pyramidal": ConeType.PYRAMIDAL,
                "elliptic": ConeType.ELLIPTIC}[o.get("cone", "pyramidal").lower()]
        integ = {"euler": IntegratorType.EULER, "rk4": IntegratorType.RK4,
                 "implicit": IntegratorType.IMPLICIT,
                 "implicitfast": IntegratorType.IMPLICITFAST}[
                     o.get("integrator", "Euler").lower()]
        disable = 0
        flagmap = {"constraint": DisableBit.CONSTRAINT,
                   "equality": DisableBit.EQUALITY,
                   "frictionloss": DisableBit.FRICTIONLOSS,
                   "limit": DisableBit.LIMIT, "contact": DisableBit.CONTACT,
                   "passive": DisableBit.PASSIVE,
                   "gravity": DisableBit.GRAVITY,
                   "clampctrl": DisableBit.CLAMPCTRL,
                   "actuation": DisableBit.ACTUATION,
                   "eulerdamp": DisableBit.EULERDAMP}
        for k, v in fl.items():
            if k in flagmap and v == "disable":
                disable |= int(flagmap[k])
        grav = _pad(_floats(o.get("gravity", "0 0 -9.81")), 3)
        wind = _pad(_floats(o.get("wind", "0 0 0")), 3)
        return Option(
            timestep=float(o.get("timestep", 0.002)),
            impratio=float(o.get("impratio", 1.0)),
            tolerance=float(o.get("tolerance", 1e-8)),
            ls_tolerance=float(o.get("ls_tolerance", 0.01)),
            integrator=int(integ), cone=int(cone), solver=int(solver),
            iterations=int(o.get("iterations", 100)),
            ls_iterations=int(o.get("ls_iterations", 50)),
            disableflags=disable,
            gravity=tuple(float(x) for x in grav),
            wind=tuple(float(x) for x in wind),
            density=float(o.get("density", 0.0)),
            viscosity=float(o.get("viscosity", 0.0)),
        )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _type_key(t1: int, t2: int) -> Tuple[GeomType, GeomType]:
    a, b = GeomType(int(t1)), GeomType(int(t2))
    return (a, b) if a <= b else (b, a)


def _rbound(g: Dict) -> float:
    t, s = g["type"], g["size"]
    if t == GeomType.PLANE:
        return 0.0
    if t == GeomType.SPHERE:
        return s[0]
    if t in (GeomType.CAPSULE,):
        return s[0] + s[1]
    if t == GeomType.CYLINDER:
        return math.sqrt(s[0] ** 2 + s[1] ** 2)
    if t == GeomType.ELLIPSOID:
        return float(np.max(s))
    if t == GeomType.BOX:
        return float(np.linalg.norm(s))
    return float(np.max(s))


def _geom_mass_inertia(g: Dict) -> Tuple[float, np.ndarray]:
    """Mass and principal-frame diagonal inertia of one geom about its com."""
    t, s = g["type"], g["size"]
    r, h = s[0], s[1]
    if t == GeomType.PLANE:
        return 0.0, np.zeros(3)
    if t == GeomType.SPHERE:
        vol = 4.0 / 3.0 * math.pi * r ** 3
        m = g["mass"] if g["mass"] is not None else g["density"] * vol
        i = 0.4 * m * r ** 2
        return m, np.array([i, i, i])
    if t == GeomType.CAPSULE:
        H = 2.0 * h
        vol_c = math.pi * r * r * H
        vol_s = 4.0 / 3.0 * math.pi * r ** 3
        if g["mass"] is not None:
            density = g["mass"] / (vol_c + vol_s)
        else:
            density = g["density"]
        mc, ms = density * vol_c, density * vol_s
        iz = 0.5 * mc * r * r + 0.4 * ms * r * r
        ix = (mc * (r * r / 4.0 + H * H / 12.0)
              + ms * (0.4 * r * r + 0.25 * H * H + 0.375 * r * H))
        return mc + ms, np.array([ix, ix, iz])
    if t == GeomType.CYLINDER:
        H = 2.0 * h
        vol = math.pi * r * r * H
        m = g["mass"] if g["mass"] is not None else g["density"] * vol
        iz = 0.5 * m * r * r
        ix = m * (3.0 * r * r + H * H) / 12.0
        return m, np.array([ix, ix, iz])
    if t == GeomType.ELLIPSOID:
        a, b, c = s
        vol = 4.0 / 3.0 * math.pi * a * b * c
        m = g["mass"] if g["mass"] is not None else g["density"] * vol
        return m, 0.2 * m * np.array([b * b + c * c, a * a + c * c,
                                      a * a + b * b])
    if t == GeomType.BOX:
        a, b, c = s
        vol = 8.0 * a * b * c
        m = g["mass"] if g["mass"] is not None else g["density"] * vol
        return m, m / 3.0 * np.array([b * b + c * c, a * a + c * c,
                                      a * a + b * b])
    raise NotImplementedError(f"inertia for geom type {t}")


def _body_inertia_from_geoms(gs) -> Tuple[float, np.ndarray, np.ndarray]:
    if not gs:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    masses, coms, tensors = [], [], []
    for g, pos, quat in gs:
        m, diag = _geom_mass_inertia(g)
        R = _quat_to_mat_np(quat)
        masses.append(m)
        coms.append(pos)
        tensors.append(R @ np.diag(diag) @ R.T)
    M = float(sum(masses))
    if M <= 0.0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    com = sum(m * c for m, c in zip(masses, coms)) / M
    itot = np.zeros((3, 3))
    for m, c, I in zip(masses, coms, tensors):
        d = c - com
        itot += I + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return M, com, itot


def _principal_inertia(itensor: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    if not np.any(itensor):
        return np.zeros(3), np.array([1.0, 0, 0, 0])
    w, v = np.linalg.eigh(itensor)
    order = np.argsort(-w)  # MuJoCo sorts descending
    w, v = w[order], v[:, order]
    if np.linalg.det(v) < 0:
        v[:, 2] *= -1
    return w, _mat_to_quat_np(v)


# numpy-side quaternion helpers (compiler is host code)
def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _mat_to_quat_np(m):
    tr = np.trace(m)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def _axis_angle_quat_np(axis, angle):
    return np.concatenate([[math.cos(0.5 * angle)],
                           axis * math.sin(0.5 * angle)])


def _euler_to_quat_np(e, seq):
    basis = {"x": np.array([1.0, 0, 0]), "y": np.array([0, 1.0, 0]),
             "z": np.array([0, 0, 1.0])}
    q = np.array([1.0, 0, 0, 0])
    for i, ax in enumerate(seq):
        qi = _axis_angle_quat_np(basis[ax.lower()], e[i])
        if ax.islower():
            q = _quat_mul_np(q, qi)
        else:
            q = _quat_mul_np(qi, q)
    return q / np.linalg.norm(q)


def _quat_mul_np(u, v):
    uw, ux, uy, uz = u
    vw, vx, vy, vz = v
    return np.array([
        uw * vw - ux * vx - uy * vy - uz * vz,
        uw * vx + ux * vw + uy * vz - uz * vy,
        uw * vy - ux * vz + uy * vw + uz * vx,
        uw * vz + ux * vy - uy * vx + uz * vw])


def _z_to_quat_np(z):
    """Minimal rotation taking (0,0,1) to z."""
    z = z / np.linalg.norm(z)
    axis = np.cross([0.0, 0.0, 1.0], z)
    s = np.linalg.norm(axis)
    c = z[2]
    if s < 1e-12:
        if c > 0:
            return np.array([1.0, 0, 0, 0])
        return np.array([0.0, 1.0, 0, 0])  # 180 deg about x
    axis = axis / s
    angle = math.atan2(s, c)
    return _axis_angle_quat_np(axis, angle)


def _combine_solref(sr1, sr2, w1, w2):
    if min(sr1[0], sr2[0]) <= 0:
        return np.minimum(sr1, sr2)
    return w1 * sr1 + w2 * sr2


def _make_pairs(spec, geoms, geom_bodyid, geom_type, body_parentid,
                body_jntnum, gmap, bmap, comp: _Compiler):
    nbody = len(body_parentid)
    # weld id: body welded to parent when jointless
    weldid = np.zeros(nbody, dtype=np.int32)
    for b in range(1, nbody):
        weldid[b] = b if body_jntnum[b] > 0 else weldid[body_parentid[b]]
    weld_parent = np.zeros(nbody, dtype=np.int32)
    for b in range(nbody):
        weld_parent[b] = weldid[body_parentid[weldid[b]]]

    excluded = set()
    for ex in spec.contact_excludes:
        b1, b2 = bmap[ex.get("body1")], bmap[ex.get("body2")]
        excluded.add((min(b1, b2), max(b1, b2)))

    pairs = []
    seen = set()

    # explicit <pair> elements first (MuJoCo order)
    for el in spec.contact_pairs:
        g1, g2 = gmap[el.get("geom1")], gmap[el.get("geom2")]
        if g1 > g2:
            g1, g2 = g2, g1
        res = lambda k: comp.spec.resolve("pair", el, k) or _PAIR_DEFAULTS[k]
        condim = int(el.get("condim", res("condim")))
        pairs.append(dict(
            g1=g1, g2=g2, condim=condim,
            friction=_fill(res("friction"),
                           np.array([1.0, 1.0, 0.005, 0.0001, 0.0001])),
            solref=_fill(res("solref"), np.array([0.02, 1.0])),
            solimp=_solimp(res("solimp")),
            margin=float(res("margin")), gap=float(res("gap"))))
        seen.add((g1, g2))

    # dynamic pairs from contype/conaffinity
    ngeom = len(geoms)
    for g1 in range(ngeom):
        for g2 in range(g1 + 1, ngeom):
            if (g1, g2) in seen:
                continue
            b1, b2 = geom_bodyid[g1], geom_bodyid[g2]
            w1, w2 = weldid[b1], weldid[b2]
            if w1 == w2:
                continue
            # parent-child filter (world excepted)
            if (weld_parent[b1] == w2 and w2 != 0) or \
               (weld_parent[b2] == w1 and w1 != 0):
                continue
            if (min(w1, w2), max(w1, w2)) in excluded or \
               (min(b1, b2), max(b1, b2)) in excluded:
                continue
            ga, gb = geoms[g1], geoms[g2]
            if not ((ga["contype"] & gb["conaffinity"]) or
                    (gb["contype"] & ga["conaffinity"])):
                continue
            key = _type_key(geom_type[g1], geom_type[g2])
            if key not in _PAIR_NCON:
                raise NotImplementedError(
                    f"no narrowphase for geom types {key} "
                    f"({comp.geom_name[g1]} vs {comp.geom_name[g2]})")
            # parameter combination (mj_contactParam semantics)
            if ga["priority"] != gb["priority"]:
                hi = ga if ga["priority"] > gb["priority"] else gb
                condim = hi["condim"]
                f = hi["friction"]
                friction = np.array([f[0], f[0], f[1], f[2], f[2]])
                solref, solimp = hi["solref"], hi["solimp"]
            else:
                condim = max(ga["condim"], gb["condim"])
                f = np.maximum(ga["friction"], gb["friction"])
                friction = np.array([f[0], f[0], f[1], f[2], f[2]])
                mix1, mix2 = ga["solmix"], gb["solmix"]
                tot = mix1 + mix2
                wa, wb = ((mix1 / tot, mix2 / tot) if tot > 1e-15
                          else (0.5, 0.5))
                solref = _combine_solref(ga["solref"], gb["solref"], wa, wb)
                solimp = wa * ga["solimp"] + wb * gb["solimp"]
            pairs.append(dict(
                g1=g1, g2=g2, condim=condim, friction=friction,
                solref=solref, solimp=solimp,
                margin=max(ga["margin"], gb["margin"]),
                gap=max(ga["gap"], gb["gap"])))

    # order plane (or lower type code) first within each pair for narrowphase
    for p in pairs:
        if geom_type[p["g1"]] > geom_type[p["g2"]]:
            p["g1"], p["g2"] = p["g2"], p["g1"]
    return pairs


def _to_numpy(fields: Dict) -> Dict[str, np.ndarray]:
    """The compiled fields as ``model_to_numpy`` writes a Model: Option
    fields as ``opt_<name>``, sizes as 0-d ints, names as unicode arrays."""
    out = {}
    for name, v in fields.items():
        if name == "opt":
            for g in dataclasses.fields(v):
                out[f"opt_{g.name}"] = np.asarray(getattr(v, g.name))
        elif isinstance(v, tuple) and (not v or isinstance(v[0], str)):
            out[name] = np.asarray(v, dtype=np.str_)
        else:
            out[name] = np.asarray(v)
    return out


def compile_numpy(spec: MjcfSpec) -> Dict[str, np.ndarray]:
    """The compiled model's fields as numpy arrays."""
    return _Compiler(spec).compile()


def compile_spec(spec: MjcfSpec, device="cuda"):
    """A torch Model on ``device`` from a parsed spec."""
    from vnl_tpu_torch import compat
    return compat.model_from_numpy(compile_numpy(spec), device=device)


def load_spec(path_or_xml: str, *,
              rescale: Optional[Tuple[float, float]] = None,
              torque_actuators: bool = False,
              overrides: Optional[Dict] = None) -> MjcfSpec:
    """Parses an MJCF and applies the reference's model edits."""
    from vnl_tpu_torch.mjcf import transforms

    spec = parse(path_or_xml)
    if torque_actuators:
        spec = transforms.to_torque_actuators(spec)
    if rescale is not None:
        spec = transforms.rescale_subtree(spec, rescale[0], rescale[1])
    if overrides:
        spec.option.update({k: str(v) for k, v in overrides.items()})
    return spec


def load_model(path_or_xml: str, *,
               rescale: Optional[Tuple[float, float]] = None,
               torque_actuators: bool = False,
               overrides: Optional[Dict] = None, device="cuda"):
    """One-call MJCF -> Model pipeline with the reference's model edits;
    the Model's tensors go to ``device``.

    Args:
      path_or_xml: MJCF file path or XML string.
      rescale: optional (position_factor, size_factor) subtree rescale
        (the rodent's scale_factor is 0.9).
      torque_actuators: convert position servos to torque actuators (the
        rodent pipeline).
      overrides: option overrides, e.g. {"solver": "cg", "iterations": 6}.
    """
    return compile_spec(load_spec(path_or_xml, rescale=rescale,
                                  torque_actuators=torque_actuators,
                                  overrides=overrides), device=device)
