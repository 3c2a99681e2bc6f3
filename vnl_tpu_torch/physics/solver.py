"""Constraint solvers over joint accelerations: primal CG and Newton
(PyTorch counterpart of vnl_tpu/physics/solver.py), batched.

  min_x  0.5 (x - a_smooth)^T M (x - a_smooth) + s(J x - aref)

where s is 0.5 sum_i D_i [jar_i < 0] jar_i^2 over the limit rows and the
pyramid facets, and for elliptic contacts the cost of the D-metric
projection onto the friction cone (``_elliptic_zones``).  Fixed iteration
counts, no early exit.

Which path runs:
- CG on a factored pyramidal system with contacts: forward sends it to
  kernel B (ops/cg.py solve), not here; ``_cg_loop`` is the body of its
  plain version.
- CG on the dense Jacobian (the elliptic cone) or without contacts: the
  plain ``_cg_loop``.  As in the JAX package, an elliptic CG solve never
  takes kernel B: the fused solve wants a factored system (con_Jc None),
  and make_constraints builds the dense Jacobian for every elliptic model.
- Newton: H = M + J^T H_s J assembled from the factored blocks and the
  dense Jacobian; its inverse goes through kernel C (ops/sweep.py) on a
  CUDA tensor and through the plain ops/linalg.inv_spd on a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vnl_tpu_torch.ops import linalg, sweep
from vnl_tpu_torch.physics.constraint import EfcSystem
from vnl_tpu_torch.physics.model import Data, Model, SolverType


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _mv(M, x):
    return torch.einsum("nij,nj->ni", M, x)


def _elliptic_zones(efc: EfcSystem, con_jar):
    """Per-contact cone zones for jar = (N, t1, t2): top (separated,
    N >= mu T) has no force; bottom (-D jar inside the cone) has
    f = -D jar; middle (on the cone) has f_n = c (mu T - N),
    f_t = -mu f_n t / T with c = Dn Dt / (Dt + mu^2 Dn).
    Returns (N, t, T, mu, Dn, Dt, top, bottom, fn_mid, c)."""
    mu = efc.con_mu[..., 0]
    Dn, Dt = efc.con_D[..., 0], efc.con_D[..., 1]
    N, t = con_jar[..., 0], con_jar[..., 1:]
    T = torch.sqrt(torch.sum(t * t, -1) + 1e-20)
    top = N >= mu * T
    bottom = ~top & (Dt * T <= -mu * Dn * N)
    c = Dn * Dt / (Dt + mu * mu * Dn + 1e-20)
    return N, t, T, mu, Dn, Dt, top, bottom, c * (mu * T - N), c


def _elliptic_force(efc: EfcSystem, con_jar):
    N, t, T, mu, Dn, Dt, top, bottom, fn_mid, _ = _elliptic_zones(efc,
                                                                  con_jar)
    zero = torch.zeros_like(N)
    fn = torch.where(top, zero, torch.where(bottom, -Dn * N, fn_mid))
    ft = torch.where(top[..., None], torch.zeros_like(t),
                     torch.where(bottom[..., None], -Dt[..., None] * t,
                                 -(mu * fn_mid / T)[..., None] * t))
    return torch.cat([fn[..., None], ft], -1)


def _forces(efc: EfcSystem, lim_jx, con_fx):
    """Forces per block: the active set f = -D [jar < 0] jar of limits and
    pyramid facets, the cone projection of elliptic contacts."""
    lim_jar = lim_jx - efc.lim_aref
    con_jar = con_fx - efc.con_aref
    lim_f = -efc.lim_D * (lim_jar < 0) * lim_jar
    if efc.elliptic and efc.ncon:
        con_f = _elliptic_force(efc, con_jar)
    else:
        con_f = -efc.con_D * (con_jar < 0) * con_jar
    return lim_jar, con_jar, lim_f, con_f


def _line_search_elliptic(ls_iters: int, efc: EfcSystem, p, Mx_minus_a,
                          Mp, lim_jar, con_jar, lim_jp, con_jp):
    """alpha by bracket and bisection on the exact phi'(alpha) of the
    elliptic cost, which is convex along p: the bracket [0, hi] grows by 4
    for 12 rounds while phi'(hi) < 0, then 4 ls_iters halvings."""
    quad_num0 = _dot(p, Mx_minus_a)
    quad_den0 = _dot(p, Mp)

    def dphi(alpha):
        ljar = lim_jar + alpha[:, None] * lim_jp
        con_f = _elliptic_force(efc, con_jar + alpha[:, None, None] * con_jp)
        return (quad_num0 + alpha * quad_den0
                + torch.sum(efc.lim_D * (ljar < 0.0) * ljar * lim_jp, -1)
                - torch.sum(con_f * con_jp, (-1, -2)))

    lo = torch.zeros_like(quad_num0)
    hi = torch.ones_like(quad_num0)
    for _ in range(12):
        hi = torch.where(dphi(hi) < 0.0, hi * 4.0, hi)
    for _ in range(max(ls_iters, 1) * 4):
        mid = 0.5 * (lo + hi)
        neg = dphi(mid) < 0.0
        lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
    return torch.where(dphi(torch.zeros_like(lo)) >= 0.0, torch.zeros_like(lo),
                       0.5 * (lo + hi))


def _line_search(ls_iters: int, efc: EfcSystem, p, Mx_minus_a, Mp,
                 lim_jar, con_jar, lim_jp, con_jp):
    """Exact line search on the piecewise-quadratic cost along p:
    ls_iters rounds of active-set refinement from alpha = 0 (bracket and
    bisection for elliptic contacts)."""
    if efc.elliptic and efc.ncon:
        return _line_search_elliptic(ls_iters, efc, p, Mx_minus_a, Mp,
                                     lim_jar, con_jar, lim_jp, con_jp)
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


def _pyramid_hess_blocks(efc: EfcSystem, con_jar):
    """Per-contact 3 x 3 Hessian of the facet cost in the contact frame:
    sum over active facets of D_k c_k c_k^T, c_k = (1, +-mu, 0) or
    (1, 0, +-mu)."""
    w = efc.con_D * (con_jar < 0)                      # (B, ncon, 4)
    mu1, mu2 = efc.con_mu[..., 0], efc.con_mu[..., 1]
    one, zero = torch.ones_like(mu1), torch.zeros_like(mu1)
    c = torch.stack([torch.stack([one, mu1, zero], -1),
                     torch.stack([one, -mu1, zero], -1),
                     torch.stack([one, zero, mu2], -1),
                     torch.stack([one, zero, -mu2], -1)], -2)  # (B, c, 4, 3)
    return torch.einsum("bck,bckf,bckg->bcfg", w, c, c)


def _elliptic_hess_blocks(efc: EfcSystem, con_jar):
    """Per-contact 3 x 3 Hessian of the elliptic cost in jar = (N, t):
    0 on top, diag(Dn, Dt, Dt) at the bottom, and in the middle
    c [[1, -mu t^], [-mu t^, mu^2 t^ t^' + mu (mu T - N)/T (I - t^ t^')]],
    t^ = t / T, the exact second derivative of 0.5 c (mu T - N)^2."""
    N, t, T, mu, Dn, Dt, top, bottom, _, c = _elliptic_zones(efc, con_jar)
    that = t / T[..., None]
    tt = that[..., :, None] * that[..., None, :]        # (B, ncon, 2, 2)
    eye2 = torch.eye(2, dtype=con_jar.dtype, device=con_jar.device)
    mid_tt = ((mu * mu)[..., None, None] * tt
              + (mu * (mu * T - N) / T)[..., None, None] * (eye2 - tt))
    nt = -(mu[..., None] * that)
    top_row = torch.cat([torch.ones_like(N)[..., None], nt], -1)
    bot_rows = torch.cat([nt[..., :, None], mid_tt], -1)
    Hb_mid = c[..., None, None] * torch.cat([top_row[..., None, :], bot_rows],
                                            -2)
    Hb_bottom = (torch.stack([Dn, Dt, Dt], -1)[..., :, None]
                 * torch.eye(3, dtype=con_jar.dtype, device=con_jar.device))
    Hb = torch.where(bottom[..., None, None], Hb_bottom, Hb_mid)
    return torch.where(top[..., None, None], torch.zeros_like(Hb), Hb)


def inv_spd(H: torch.Tensor) -> torch.Tensor:
    """Newton's H^-1: kernel C on a CUDA tensor (no fallback: a build or
    launch failure raises), the plain recursive Schur inverse on a CPU
    tensor."""
    return sweep.inv_spd_sweep(H.contiguous(), plain=linalg.inv_spd)


def newton_hessian(d: Data, efc: EfcSystem, lim_jar, con_jar):
    """H = M + J^T H_s J (B, nv, nv) at the residuals jar: the active limit
    rows' D on their dofs, and the contacts' 3 x 3 cost Hessians through
    the dense contact Jacobian."""
    lim_w = efc.lim_D * (lim_jar < 0)
    H = d.qM + torch.einsum("lv,bl,lw->bvw", efc.lim_onehot, lim_w,
                            efc.lim_onehot)
    if efc.ncon:
        W = (_elliptic_hess_blocks(efc, con_jar) if efc.elliptic
             else _pyramid_hess_blocks(efc, con_jar))
        WJ = torch.einsum("bcfg,bcgw->bcfw", W, efc.con_Jc)
        H = H + torch.einsum("bcfv,bcfw->bvw", efc.con_Jc, WJ)
    return H


def _newton_loop(m: Model, d: Data, efc: EfcSystem, qacc_smooth,
                 n_iter: int):
    """Newton on the primal problem: p = -H^-1 g with
    H = M + J^T H_s J, then the exact line search along p."""

    def grad_at(x, lim_jx, con_fx):
        _, _, lim_f, con_f = _forces(efc, lim_jx, con_fx)
        return _mv(d.qM, x - qacc_smooth) - efc.jt_f(lim_f, con_f)

    x = qacc_smooth
    lim_jx, con_fx = efc.jx(x)
    for _ in range(n_iter):
        lim_jar = lim_jx - efc.lim_aref
        con_jar = con_fx - efc.con_aref
        g = grad_at(x, lim_jx, con_fx)
        p = -_mv(inv_spd(newton_hessian(d, efc, lim_jar, con_jar)), g)
        lim_jp, con_jp = efc.jx(p)
        alpha = _line_search(m.opt.ls_iterations, efc, p,
                             _mv(d.qM, x - qacc_smooth), _mv(d.qM, p),
                             lim_jar, con_jar, lim_jp, con_jp)
        x = x + alpha[:, None] * p
        lim_jx = lim_jx + alpha[:, None] * lim_jp
        con_fx = con_fx + alpha[:, None, None] * con_jp
    return x, lim_jx, con_fx


def solve(m: Model, d: Data, efc: EfcSystem, qacc_smooth: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (qacc, qfrc_constraint, contact forces (B, ncon, rows)):
    rows are the 4 facets, or (n, t1, t2) for elliptic contacts."""
    B = qacc_smooth.shape[0]
    if efc.nefc == 0:
        return (qacc_smooth, torch.zeros_like(qacc_smooth),
                qacc_smooth.new_zeros(B, 0, 4))
    n_iter = max(m.opt.iterations, 1)
    if m.opt.solver == int(SolverType.NEWTON):
        x, lim_jx, con_fx = _newton_loop(m, d, efc, qacc_smooth, n_iter)
    else:
        x, lim_jx, con_fx = _cg_loop(d.qM, d.qMinv, efc, qacc_smooth, n_iter,
                                     m.opt.ls_iterations)
    _, _, lim_f, con_f = _forces(efc, lim_jx, con_fx)
    return x, efc.jt_f(lim_f, con_f), con_f
