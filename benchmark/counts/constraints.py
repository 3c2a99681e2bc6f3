"""Bytes of kernel D (the constraint system of a substep, kernel B's
inputs in one launch), counted from a scene's shapes at a batch of envs,
as chip_smoke.py's ``constraints_bytes`` counts them: each input byte read
once, each output byte written once; the tables, one copy for every env,
stay in L2.  Its operations are under a tenth of its bytes' time."""

from __future__ import annotations

import functools
import json
from typing import Dict

import numpy as np


def constraints_bytes(nv: int, nlimit: int, ncon: int, nroot: int,
                      batch: int) -> int:
    """Reads qpos at the limit rows, qvel, cdof, the subtree coms of the
    contacts' roots and the contacts; writes g36 and the row arrays."""
    reads = nlimit + 7 * nv + 3 * nroot + 13 * ncon
    writes = 36 * ncon + 4 * max(nlimit, 1) + 9 * ncon
    return 4 * batch * (reads + writes)


@functools.lru_cache(maxsize=None)
def _roots(reference_env: str, env_args: str) -> int:
    from benchmark import loops
    from benchmark.reference.plain.physics import collision
    env = loops.resolve(reference_env)(device="cpu", **json.loads(env_args))
    m = env.sys
    pair = collision.pair_expansion(m)
    body = np.asarray(m.geom_bodyid)
    root = np.asarray(m.body_rootid)
    sides = np.concatenate([body[np.asarray(m.pair_geom1)[pair]],
                            body[np.asarray(m.pair_geom2)[pair]]])
    return len(np.unique(root[sides]))


def contact_roots(cfg: Dict) -> int:
    """The distinct root bodies of the contacts' two sides in
    configuration ``cfg``, read from its reference model."""
    return _roots(cfg["reference"]["env"],
                  json.dumps(cfg["env_args"], sort_keys=True))


def constraints_cost(cfg: Dict, s: Dict, batch: int):
    """(bytes, flops) of one launch of kernel D over ``batch`` envs of
    configuration ``cfg`` with scene shapes ``s`` (counts/scene.py); the
    operations are left at 0."""
    return (float(constraints_bytes(s["nv"], s["nlimit"], s["ncon"],
                                    contact_roots(cfg), batch)), 0.0)
