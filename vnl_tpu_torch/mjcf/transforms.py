"""Compile-time spec transforms (a copy of vnl_tpu/mjcf/transforms.py).

The upstream reference performs these edits at runtime through dm_control's
mjcf tree (its envs/rodent.py:39-52 and preprocessing/mjx_preprocess.py:
75-81); here they are pure functions on the parsed spec, applied before
compilation.
"""

from __future__ import annotations

import numpy as np

from vnl_tpu_torch.mjcf.parser import MjcfElement, MjcfSpec


def _scale_attr(el: MjcfElement, key: str, factor: float) -> None:
    if key in el.attrib:
        v = np.fromstring(el.attrib[key], sep=" ") * factor
        el.attrib[key] = " ".join(repr(float(x)) for x in v)


def rescale_subtree(spec: MjcfSpec, position_factor: float,
                    size_factor: float) -> MjcfSpec:
    """Geometric rescale of the whole worldbody tree (in place; returns spec).

    Mirrors dm_control.locomotion.walkers.rescale.rescale_subtree as invoked
    by the reference on the model root: every element under <worldbody> has
    its *explicit* ``pos`` scaled by position_factor, ``size`` by
    size_factor, and ``fromto`` decomposed into midpoint (position_factor) +
    half-extent (size_factor).  Attributes coming from default classes are
    untouched, exactly as in the reference pipeline.
    """

    def walk(el: MjcfElement):
        for child in el.children:
            if "fromto" in child.attrib:
                ft = np.fromstring(child.attrib["fromto"], sep=" ")
                mid = position_factor * 0.5 * (ft[3:] + ft[:3])
                half = size_factor * 0.5 * (ft[3:] - ft[:3])
                new = np.concatenate([mid - half, mid + half])
                child.attrib["fromto"] = " ".join(repr(float(x)) for x in new)
            _scale_attr(child, "pos", position_factor)
            _scale_attr(child, "size", size_factor)
            if child.tag in ("body", "worldbody"):
                walk(child)

    walk(spec.worldbody)
    _scale_attr(spec.worldbody, "pos", position_factor)
    return spec


def to_torque_actuators(spec: MjcfSpec) -> MjcfSpec:
    """Converts position-servo actuators to direct torque actuators.

    Upstream semantics (its envs/rodent.py:42-45): for every
    actuator, set gainprm = [forcerange_hi] and delete the affine bias, so
    force = forcerange_hi * act with act filtered from ctrl in [-1, 1].
    dyntype/dynprm (activation filter) are intentionally preserved.
    """
    for act in spec.actuators:
        fr = spec.resolve(act.tag, act, "forcerange")
        if fr is None:
            continue
        hi = np.fromstring(fr, sep=" ")[1]
        act.attrib["gainprm"] = repr(float(hi))
        act.attrib.pop("biastype", None)
        act.attrib.pop("biasprm", None)
        # make sure class-level bias does not resurface after deletion
        act.attrib["_nobias"] = "true"
    return spec
