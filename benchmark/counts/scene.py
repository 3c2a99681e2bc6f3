"""A configuration's scene shapes, read from the reference's own copy of
its model (not from the program): the sizes that kernel A's and kernel
B's counts take, and the substeps of a control step."""

from __future__ import annotations

import functools
import json
from typing import Dict

import numpy as np


@functools.lru_cache(maxsize=None)
def _shapes(reference_env: str, env_args: str) -> Dict:
    from benchmark import loops
    from benchmark.reference.plain.physics import forward, inertia
    env = loops.resolve(reference_env)(device="cpu", **json.loads(env_args))
    m = env.sys
    _, efc = forward.fwd_position(m, forward.make_data(m, 1))
    return dict(nq=m.nq, nv=m.nv, nbody=m.nbody, njnt=m.njnt,
                ngeom=m.ngeom,
                damped=int(inertia.needs_implicit_damping(m)),
                ncon=int(efc.ncon), nlimit=max(int(efc.nlimit), 1),
                chain=float(np.sum(efc.con_chain1) + np.sum(efc.con_chain2)),
                iters=max(int(m.opt.iterations), 1),
                ls_iters=max(int(m.opt.ls_iterations), 1),
                substeps=int(env.n_frames))


def shapes(cfg: Dict) -> Dict:
    """The scene shapes of configuration ``cfg`` (a configuration file's
    contents)."""
    return dict(_shapes(cfg["reference"]["env"],
                        json.dumps(cfg["env_args"], sort_keys=True)))
