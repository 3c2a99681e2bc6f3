"""Bytes and operations of kernel A (the position stage) and kernel B (the
CG contact solve), counted from a scene's shapes at a batch of envs: each
input byte read once, each output byte written once, and the floating
operations the algorithm needs for these inputs (a fixed number of CG
iterations: the solvers never stop early).  Copied from chip_smoke.py's
bounds, which these counts replace."""

from __future__ import annotations

from typing import Dict, Tuple

# scene shapes: nq, nv, nbody, njnt, ngeom, damped (0 or 1), ncon, nlimit,
# chain (the ones of the contacts' two dof chains), iters, ls_iters


def position_out_floats(s: Dict) -> int:
    """Floats kernel A writes for one env."""
    nb, nj, nv, ng = s["nbody"], s["njnt"], s["nv"], s["ngeom"]
    per = (nb * 3 + nb * 4 + nb * 9 + nb * 3 + nj * 3 + nj * 3 + ng * 3
           + ng * 9 + nb * 3 + nb * 36 + nv * 6 + nv * nv + nv * nv)
    return per + (nv * nv if s["damped"] else 0)


def position_cost(s: Dict, batch: int) -> Tuple[float, float]:
    """(bytes, flops) of one launch of kernel A over ``batch`` envs: qpos
    in, the stage's outputs out; the operations of the SPD sweeps (one
    matrix, two when damped), the rest being under 5% of them."""
    nmat = 2 if s["damped"] else 1
    nbytes = batch * 4 * (s["nq"] + position_out_floats(s))
    flops = batch * 2 * nmat * s["nv"] ** 3
    return float(nbytes), float(flops)


def cg_cost(s: Dict, batch: int) -> Tuple[float, float]:
    """(bytes, flops) of one CG solve of ``batch`` envs (kernel B)."""
    nv, nc, nl = s["nv"], s["ncon"], s["nlimit"]
    args = 2 * nv * nv + 7 * nv + 46 * nc + 3 * nl   # floats in, one env
    nbytes = batch * 4 * args + batch * (2 * nv + 4 * nc) * 4
    chain = float(s["chain"])
    jx = 2 * 6 * chain + nc * 3 * 12 * 2 + nl
    jtf = nc * 2 * 6 * 3 * 2 + 2 * 6 * chain + nv * 12 + nl
    ls = s["ls_iters"] * (nl + 4 * nc) * 6
    per_iter = 2 * 2 * nv * nv + jx + jtf + ls + 10 * nv
    flops = batch * (s["iters"] * per_iter + jx + jtf + 2 * nv * nv)
    return float(nbytes), float(flops)
