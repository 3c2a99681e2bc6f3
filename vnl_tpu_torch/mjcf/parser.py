"""MJCF XML parser -> explicit-attribute spec tree (a copy of
vnl_tpu/mjcf/parser.py, which imports no JAX; the port keeps its own).

Parses the MJCF subset exercised by the reference assets (ant, humanoid,
rodent: bodies/joints/freejoint/geoms/sites/inertial, nested defaults with
classes and childclass, motor/general actuators, contact pair/exclude,
keyframes, option/compiler/custom).  Visual-only elements (asset textures,
cameras, lights, skins) are retained as inert children for potential use by
a renderer but do not affect compilation.

Defaults are NOT materialized at parse time: each element keeps only its
explicit attributes plus a resolved default-class name.  This mirrors
dm_control's mjcf tree semantics, which the reference's runtime edits
(rescale, actuator retarget) rely on — spec transforms scale explicit
attributes only (cf. dm_control rescale_subtree).
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class MjcfElement:
    """One element: tag, explicit attributes, default class, children."""

    tag: str
    attrib: Dict[str, str]
    childclass: Optional[str]  # resolved default class for this element
    children: List["MjcfElement"] = dataclasses.field(default_factory=list)

    def find_all(self, tag: str) -> List["MjcfElement"]:
        out = []
        stack = [self]
        while stack:
            el = stack.pop()
            if el.tag == tag:
                out.append(el)
            stack.extend(reversed(el.children))
        return out

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self.attrib.get(key, default)


@dataclasses.dataclass
class MjcfSpec:
    """Parsed model: defaults tree + element trees + global options."""

    model_name: str
    compiler: Dict[str, str]
    option: Dict[str, str]
    option_flags: Dict[str, str]
    # defaults[class_name][element_tag] -> explicit attr dict for that class
    defaults: Dict[str, Dict[str, Dict[str, str]]]
    # parent class of each default class ("" = top default)
    default_parent: Dict[str, str]
    worldbody: MjcfElement
    actuators: List[MjcfElement]
    sensors: List[MjcfElement]
    contact_pairs: List[MjcfElement]
    contact_excludes: List[MjcfElement]
    keyframes: List[MjcfElement]
    customs: Dict[str, np.ndarray]
    # absolute path of a binary <skin file=.../> asset, if the model ships
    # one (visual-only at runtime; consumed by render/skin.py)
    skin_file: Optional[str] = None

    # -- default resolution ---------------------------------------------------
    def class_chain(self, clazz: Optional[str]) -> List[str]:
        """Inner-to-outer list of default classes to consult."""
        chain = []
        c = clazz if clazz is not None else ""
        while True:
            chain.append(c)
            if c == "":
                break
            c = self.default_parent.get(c, "")
        return chain

    def resolve(self, el_tag: str, el: Optional[MjcfElement], key: str,
                default: Optional[str] = None, clazz: Optional[str] = None) -> Optional[str]:
        """Attribute lookup: explicit -> class defaults (inner to outer) -> default."""
        if el is not None:
            if key in el.attrib:
                return el.attrib[key]
            if clazz is None:
                clazz = el.attrib.get("class", el.childclass)
        for c in self.class_chain(clazz):
            d = self.defaults.get(c, {}).get(el_tag, {})
            if key in d:
                return d[key]
        return default


def _parse_defaults(node: ET.Element, parent_class: str,
                    defaults: Dict, default_parent: Dict) -> None:
    clazz = node.get("class", "" if parent_class == "<root>" else None)
    if clazz is None:
        raise ValueError("nested <default> element must have a class name")
    default_parent[clazz] = "" if parent_class == "<root>" else parent_class
    table = defaults.setdefault(clazz, {})
    for child in node:
        if child.tag == "default":
            _parse_defaults(child, clazz, defaults, default_parent)
        else:
            d = table.setdefault(child.tag, {})
            d.update(child.attrib)


def _parse_element(node: ET.Element, childclass: Optional[str]) -> MjcfElement:
    attrib = dict(node.attrib)
    own_childclass = attrib.get("childclass", childclass)
    el = MjcfElement(tag=node.tag, attrib=attrib, childclass=childclass)
    for child in node:
        el.children.append(_parse_element(child, own_childclass))
    return el


# ---------------------------------------------------------------------------
# <replicate> expansion (mirrors MuJoCo's compile-time macro: the subtree is
# duplicated `count` times under an accumulating (offset, euler) transform,
# every name gains `sep + i`, and top-level elements referencing replicated
# names — actuators, sensors, contact pairs/excludes — are replicated too;
# cf. rodent_pair.xml:163 / humanoid_pair.xml:109)
# ---------------------------------------------------------------------------

_REF_ATTRS = ("joint", "site", "body", "body1", "body2", "geom", "geom1",
              "geom2", "target", "tendon", "actuator", "objname")


def _quat_mul(u, v):
    uw, ux, uy, uz = u
    vw, vx, vy, vz = v
    return np.array([
        uw * vw - ux * vx - uy * vy - uz * vz,
        uw * vx + ux * vw + uy * vz - uz * vy,
        uw * vy - ux * vz + uy * vw + uz * vx,
        uw * vz + ux * vy - uy * vx + uz * vw])


def _euler_quat(e, seq):
    basis = {"x": np.array([1.0, 0, 0]), "y": np.array([0, 1.0, 0]),
             "z": np.array([0, 0, 1.0])}
    q = np.array([1.0, 0, 0, 0])
    for i, ax in enumerate(seq):
        a = float(e[i])
        qi = np.concatenate([[np.cos(0.5 * a)],
                             basis[ax.lower()] * np.sin(0.5 * a)])
        q = _quat_mul(q, qi) if ax.islower() else _quat_mul(qi, q)
    return q / np.linalg.norm(q)


def _quat_rot(q, v):
    w, x, y, z = q
    u = np.array([x, y, z])
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _collect_names(el, out):
    if "name" in el.attrib:
        out.add(el.attrib["name"])
    for c in el.children:
        _collect_names(c, out)


def _rename_tree(el, names, suffix):
    if el.attrib.get("name"):
        el.attrib["name"] = el.attrib["name"] + suffix
    for k in _REF_ATTRS:
        if el.attrib.get(k) in names:
            el.attrib[k] = el.attrib[k] + suffix
    for c in el.children:
        _rename_tree(c, names, suffix)


def _expand_replicates(spec: MjcfSpec) -> None:
    import copy as _copy

    degree = spec.compiler.get("angle", "degree") == "degree"
    seq = spec.compiler.get("eulerseq", "xyz")
    reps = []  # (names, count, sep) per replicate block

    def transform_frame(el, t, q):
        """Applies the accumulated replica transform to a frame-bearing
        top-level element (pos rotated+offset; orientation left-composed)."""
        pos = np.fromstring(el.attrib.get("pos", "0 0 0"), sep=" ")
        el.attrib["pos"] = " ".join(repr(float(x))
                                    for x in t + _quat_rot(q, pos))
        if "quat" in el.attrib:
            q0 = np.fromstring(el.attrib["quat"], sep=" ")
        elif "euler" in el.attrib:
            e = np.fromstring(el.attrib["euler"], sep=" ")
            q0 = _euler_quat(np.deg2rad(e) if degree else e, seq)
            del el.attrib["euler"]
        else:
            q0 = np.array([1.0, 0, 0, 0])
        el.attrib["quat"] = " ".join(repr(float(x))
                                     for x in _quat_mul(q, q0))

    def expand_in(parent):
        out = []
        for el in parent.children:
            if el.tag != "replicate":
                expand_in(el)
                out.append(el)
                continue
            count = int(el.attrib["count"])
            sep = el.attrib.get("sep", "")
            offset = np.fromstring(el.attrib.get("offset", "0 0 0"), sep=" ")
            e = np.fromstring(el.attrib.get("euler", "0 0 0"), sep=" ")
            q_step = _euler_quat(np.deg2rad(e) if degree else e, seq)
            names = set()
            for c in el.children:
                _collect_names(c, names)
            reps.append((names, count, sep))
            t = np.zeros(3)
            q = np.array([1.0, 0, 0, 0])
            for i in range(count):
                for c in el.children:
                    cp = _copy.deepcopy(c)
                    _rename_tree(cp, names, f"{sep}{i}")
                    transform_frame(cp, t, q)
                    expand_in(cp)
                    out.append(cp)
                t = t + _quat_rot(q, offset)
                q = _quat_mul(q, q_step)
        parent.children = out

    expand_in(spec.worldbody)

    for names, count, sep in reps:
        for attr in ("actuators", "sensors", "contact_pairs",
                     "contact_excludes"):
            lst = getattr(spec, attr)
            out = []
            for el in lst:
                if not any(el.attrib.get(k) in names for k in _REF_ATTRS):
                    out.append(el)
                    continue
                for i in range(count):
                    cp = _copy.deepcopy(el)
                    _rename_tree(cp, names, f"{sep}{i}")
                    out.append(cp)
            setattr(spec, attr, out)


def parse(path_or_xml: str) -> MjcfSpec:
    """Parses an MJCF file path or XML string into a spec tree."""
    base_dir = ""
    if os.path.exists(path_or_xml):
        tree = ET.parse(path_or_xml)
        root = tree.getroot()
        base_dir = os.path.dirname(os.path.abspath(path_or_xml))
    else:
        root = ET.fromstring(path_or_xml)
    if root.tag != "mujoco":
        raise ValueError(f"expected <mujoco> root, got <{root.tag}>")

    compiler: Dict[str, str] = {}
    option: Dict[str, str] = {}
    option_flags: Dict[str, str] = {}
    defaults: Dict[str, Dict[str, Dict[str, str]]] = {"": {}}
    default_parent: Dict[str, str] = {"": ""}
    worldbody: Optional[MjcfElement] = None
    actuators: List[MjcfElement] = []
    sensors: List[MjcfElement] = []
    contact_pairs: List[MjcfElement] = []
    contact_excludes: List[MjcfElement] = []
    keyframes: List[MjcfElement] = []
    customs: Dict[str, np.ndarray] = {}
    skin_file: Optional[str] = None

    def walk_top(node: ET.Element):
        nonlocal worldbody
        for child in node:
            if child.tag == "compiler":
                compiler.update(child.attrib)
            elif child.tag == "option":
                option.update(child.attrib)
                for fl in child:
                    if fl.tag == "flag":
                        option_flags.update(fl.attrib)
            elif child.tag == "default":
                # top-level default may be anonymous (class "")
                if child.get("class") is None:
                    default_parent[""] = ""
                    table = defaults.setdefault("", {})
                    for sub in child:
                        if sub.tag == "default":
                            _parse_defaults(sub, "", defaults, default_parent)
                        else:
                            table.setdefault(sub.tag, {}).update(sub.attrib)
                else:
                    _parse_defaults(child, "<root>", defaults, default_parent)
            elif child.tag == "worldbody":
                worldbody = _parse_element(child, None)
            elif child.tag == "actuator":
                for a in child:
                    actuators.append(_parse_element(a, None))
            elif child.tag == "contact":
                for c in child:
                    if c.tag == "pair":
                        contact_pairs.append(_parse_element(c, None))
                    elif c.tag == "exclude":
                        contact_excludes.append(_parse_element(c, None))
            elif child.tag == "keyframe":
                for k in child:
                    if k.tag == "key":
                        keyframes.append(_parse_element(k, None))
            elif child.tag == "custom":
                for n in child:
                    if n.tag == "numeric":
                        customs[n.get("name")] = np.fromstring(
                            n.get("data", ""), sep=" ")
            elif child.tag == "sensor":
                for sn in child:
                    sensors.append(_parse_element(sn, None))
            elif child.tag in ("asset", "visual", "statistic", "size",
                              "tendon", "equality", "deformable"):
                # visual / unused-by-runtime sections; keep skin asset paths
                nonlocal skin_file
                for a in child:
                    if a.tag == "skin" and a.get("file"):
                        skin_file = os.path.join(base_dir, a.get("file"))
    walk_top(root)

    if worldbody is None:
        raise ValueError("MJCF file has no <worldbody>")

    spec = MjcfSpec(
        model_name=root.get("model", "model"),
        compiler=compiler,
        option=option,
        option_flags=option_flags,
        defaults=defaults,
        default_parent=default_parent,
        worldbody=worldbody,
        actuators=actuators,
        sensors=sensors,
        contact_pairs=contact_pairs,
        contact_excludes=contact_excludes,
        keyframes=keyframes,
        customs=customs,
        skin_file=skin_file,
    )
    if spec.worldbody.find_all("replicate"):
        _expand_replicates(spec)
    return spec
