"""Primal CG constraint solver over joint accelerations (PyTorch
counterpart of the CG branch of vnl_tpu/physics/solver.py), batched.

  min_x  0.5 (x - a_smooth)^T M (x - a_smooth)
         + 0.5 sum_i D_i [jar_i < 0] jar_i^2,   jar = J x - aref

Fixed iteration counts, no early exit.  With contacts the whole solve is
kernel B (ops/cg.py); ``_cg_loop`` here is its plain version's body and the
path of contact-free models.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vnl_tpu_torch.physics.constraint import EfcSystem
from vnl_tpu_torch.physics.model import Data, Model, SolverType


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _mv(M, x):
    return torch.einsum("nij,nj->ni", M, x)


def _forces(efc: EfcSystem, lim_jx, con_fx):
    """Active-set forces f = -D [jar < 0] jar per block."""
    lim_jar = lim_jx - efc.lim_aref
    con_jar = con_fx - efc.con_aref
    lim_f = -efc.lim_D * (lim_jar < 0) * lim_jar
    con_f = -efc.con_D * (con_jar < 0) * con_jar
    return lim_jar, con_jar, lim_f, con_f


def _line_search(ls_iters: int, efc: EfcSystem, p, Mx_minus_a, Mp,
                 lim_jar, con_jar, lim_jp, con_jp):
    """Exact line search on the piecewise-quadratic cost along p:
    ls_iters rounds of active-set refinement from alpha = 0."""
    quad_num0 = _dot(p, Mx_minus_a)
    quad_den0 = _dot(p, Mp)
    alpha = torch.zeros_like(quad_num0)
    for _ in range(max(ls_iters, 1)):
        lim_act = (lim_jar + alpha[:, None] * lim_jp) < 0.0
        con_act = (con_jar + alpha[:, None, None] * con_jp) < 0.0
        num = (quad_num0 + torch.sum(efc.lim_D * lim_act * lim_jar * lim_jp, -1)
               + torch.sum(efc.con_D * con_act * con_jar * con_jp, (-1, -2)))
        den = (quad_den0 + torch.sum(efc.lim_D * lim_act * lim_jp * lim_jp, -1)
               + torch.sum(efc.con_D * con_act * con_jp * con_jp, (-1, -2)))
        alpha = -num / torch.clamp(den, min=1e-12)
    return alpha


def _cg_loop(qM, qMinv, efc: EfcSystem, qacc_smooth, n_iter: int,
             ls_iters: int):
    """Preconditioned Polak-Ribiere CG (beta >= 0) on the primal problem;
    M(x - a) is recomputed every iteration."""

    def grad_at(x, lim_jx, con_fx):
        _, _, lim_f, con_f = _forces(efc, lim_jx, con_fx)
        return _mv(qM, x - qacc_smooth) - efc.jt_f(lim_f, con_f)

    x = qacc_smooth
    lim_jx, con_fx = efc.jx(x)
    g = grad_at(x, lim_jx, con_fx)
    Mg = _mv(qMinv, g)
    p = -Mg
    g_dot_Mg = _dot(g, Mg)
    for _ in range(n_iter):
        lim_jp, con_jp = efc.jx(p)
        Mp = _mv(qM, p)
        Mx_a = _mv(qM, x - qacc_smooth)
        alpha = _line_search(ls_iters, efc, p, Mx_a, Mp,
                             lim_jx - efc.lim_aref, con_fx - efc.con_aref,
                             lim_jp, con_jp)
        x = x + alpha[:, None] * p
        lim_jx = lim_jx + alpha[:, None] * lim_jp
        con_fx = con_fx + alpha[:, None, None] * con_jp
        g_new = grad_at(x, lim_jx, con_fx)
        Mg_new = _mv(qMinv, g_new)
        num = _dot(g_new, Mg_new) - _dot(g, Mg_new)
        beta = torch.clamp(num / torch.clamp(g_dot_Mg, min=1e-12), min=0.0)
        p = -Mg_new + beta[:, None] * p
        g, Mg, g_dot_Mg = g_new, Mg_new, _dot(g_new, Mg_new)
    return x, lim_jx, con_fx


def cg_inputs(m: Model, d: Data, efc: EfcSystem, qacc_smooth, n_iter: int):
    """The flat arguments and static structure of the CG solve (the
    signature of ops/cg.py, kernel B)."""
    from vnl_tpu_torch.ops import cg as cg_ops
    if efc.nlimit == 0:
        # contact-only models: one inert limit row (sign 0, D 0) keeps the
        # kernel's shapes non-empty (solver.py:253-263 in the JAX package)
        z = qacc_smooth.new_zeros(qacc_smooth.shape[0], 1)
        efc = efc.replace(lim_dof=np.zeros(1, np.int32),
                          lim_onehot=qacc_smooth.new_zeros(1, m.nv),
                          lim_sign=z, lim_aref=z, lim_D=z, lim_pos=z,
                          nlimit=1)
    g36 = torch.cat([
        efc.con_G2.permute(0, 2, 3, 1).reshape(-1, 18, efc.ncon),
        efc.con_G1.permute(0, 2, 3, 1).reshape(-1, 18, efc.ncon)], 1)
    args = (d.qM, d.qMinv, qacc_smooth.contiguous(), efc.con_cdof,
            g36.contiguous(), efc.lim_sign, efc.lim_aref, efc.lim_D,
            efc.con_mu.contiguous(), efc.con_aref, efc.con_D)
    statics = cg_ops.CgStatics.make(m.nv, efc.lim_dof, efc.con_chain1,
                                    efc.con_chain2, n_iter,
                                    max(m.opt.ls_iterations, 1))
    return args, statics


def solve(m: Model, d: Data, efc: EfcSystem, qacc_smooth: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (qacc, qfrc_constraint, contact facet forces (B, ncon, 4))."""
    B = qacc_smooth.shape[0]
    if efc.nefc == 0:
        return (qacc_smooth, torch.zeros_like(qacc_smooth),
                qacc_smooth.new_zeros(B, 0, 4))
    if m.opt.solver == int(SolverType.NEWTON):
        raise NotImplementedError("the Newton solver is not ported yet")
    n_iter = max(m.opt.iterations, 1)
    if efc.ncon > 0:                   # the whole solve is kernel B
        from vnl_tpu_torch.ops import cg as cg_ops
        args, statics = cg_inputs(m, d, efc, qacc_smooth, n_iter)
        return cg_ops.cg(*args, statics=statics)
    x, lim_jx, con_fx = _cg_loop(d.qM, d.qMinv, efc, qacc_smooth, n_iter,
                                 m.opt.ls_iterations)
    _, _, lim_f, con_f = _forces(efc, lim_jx, con_fx)
    return x, efc.jt_f(lim_f, con_f), con_f
