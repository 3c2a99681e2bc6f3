"""Kernel A: the position stage (counterpart of
vnl_tpu/ops/pallas_position.py).

``position(m, qpos)`` maps a batch of qpos (B, nq) to the 13 or 14 outputs
of vnl_tpu/physics/forward.py:59 _position_reference: xpos, xquat, xmat,
xipos, xanchor, xaxis, geom_xpos, geom_xmat, subtree_com, cinert, cdof, qM,
qMinv and, for damped models, (qM + h diag(damping))^-1.  On a CUDA tensor
it launches the hand-written kernel csrc/position.cu; on a CPU tensor it
runs ``position_plain``, the same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from benchmark.reference.plain.ops.linalg import inv_spd
from benchmark.reference.plain.physics import inertia, kinematics
from benchmark.reference.plain.physics.model import Model

OUTPUT_NAMES = ("xpos", "xquat", "xmat", "xipos", "xanchor", "xaxis",
                "geom_xpos", "geom_xmat", "subtree_com", "cinert", "cdof",
                "qM", "qMinv", "qMhBinv")


def output_shapes(m: Model):
    nb, nj, nv, ng = m.nbody, m.njnt, m.nv, m.ngeom
    shapes = [(nb, 3), (nb, 4), (nb, 3, 3), (nb, 3), (nj, 3), (nj, 3),
              (ng, 3), (ng, 3, 3), (nb, 3), (nb, 6, 6), (nv, 6), (nv, nv),
              (nv, nv)]
    return shapes + ([(nv, nv)] if inertia.needs_implicit_damping(m) else [])


def position_plain(m: Model, qpos: torch.Tensor):
    """Plain PyTorch position stage: kinematics, com_pos, CRB mass matrix
    and its inverse(s) by recursive Schur complements."""
    from benchmark.reference.plain.physics.forward import make_data
    d = make_data(m, qpos.shape[0], qpos=qpos, dtype=qpos.dtype)
    d = kinematics.kinematics(m, d)
    d = kinematics.com_pos(m, d)
    qM = inertia.assemble_qM(m, d)
    outs = [d.xpos, d.xquat, d.xmat, d.xipos, d.xanchor, d.xaxis,
            d.geom_xpos, d.geom_xmat, d.subtree_com, d.cinert, d.cdof, qM]
    if inertia.needs_implicit_damping(m):
        hB = (m.opt.timestep * m.dof_damping).to(qpos.dtype)
        inv = inv_spd(torch.stack([qM, qM + torch.diag(hB)]))
        outs += [inv[0], inv[1]]
    else:
        outs += [inv_spd(qM)]
    return tuple(outs)


def position(m: Model, qpos: torch.Tensor):
    """The position stage of a batch, in plain PyTorch on any device."""
    return position_plain(m, qpos)
