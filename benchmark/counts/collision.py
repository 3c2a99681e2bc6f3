"""Bytes of kernel E (the narrowphase of every candidate pair of a substep
in one launch), counted from a scene's model at a batch of envs: the
position and rotation of each geom that a pair names read once (12
floats), each contact slot's distance, point and frame written once (13
floats); the pair tables, one copy for every env, stay in L2.  Its
operations are under a tenth of its bytes' time."""

from __future__ import annotations

import functools
import json
from typing import Dict, Tuple

import numpy as np


def collision_bytes(ngeom: int, ncon: int, batch: int) -> int:
    """Reads 12 floats of each of ``ngeom`` geoms, writes 13 floats of each
    of ``ncon`` slots, for ``batch`` envs."""
    return 4 * batch * (12 * ngeom + 13 * ncon)


@functools.lru_cache(maxsize=None)
def _shapes(reference_env: str, env_args: str) -> Tuple[int, int]:
    from benchmark import loops
    from benchmark.reference.plain.physics import collision
    env = loops.resolve(reference_env)(device="cpu", **json.loads(env_args))
    m = env.sys
    pair = collision.pair_expansion(m)
    geoms = np.concatenate([np.asarray(m.pair_geom1)[pair],
                            np.asarray(m.pair_geom2)[pair]])
    return len(np.unique(geoms)), len(pair)


def pair_geoms_and_slots(cfg: Dict) -> Tuple[int, int]:
    """(distinct geoms of the candidate pairs, contact slots) of
    configuration ``cfg``, read from its reference model."""
    return _shapes(cfg["reference"]["env"],
                   json.dumps(cfg["env_args"], sort_keys=True))


def collision_cost(cfg: Dict, batch: int):
    """(bytes, flops) of one launch of kernel E over ``batch`` envs of
    configuration ``cfg``; the operations are left at 0."""
    return float(collision_bytes(*pair_geoms_and_slots(cfg), batch)), 0.0
