"""Constraint assembly: joint limits + pyramidal contact rows (PyTorch
counterpart of vnl_tpu/physics/constraint.py), batched over envs.

Only the factored form is ported (``materialize_jc=False`` in the JAX
package): the contact Jacobian is Jc = (chain2 * G2 - chain1 * G1) . cdof
with per-side moment arms G = [r x frame | frame] and static 0/1 chain
masks, and is never built densely.  That is the form kernel B consumes.
Soft-constraint model (MuJoCo):

  aref = -b (J qvel) - k imp pos,  b = 2/(dmax tc),  k = 1/(dmax tc dr)^2
  R = (1 - imp)/imp * diagApprox,  D = 1/R
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vnl_tpu_torch import math as vmath
from vnl_tpu_torch.physics.model import ConeType, Data, DisableBit, Model


@dataclasses.dataclass(frozen=True, eq=False)
class EfcSystem:
    """Factored constraint system of a batch (static shapes)."""

    lim_dof: np.ndarray        # (nlimit,) static dof indices
    lim_onehot: torch.Tensor   # (nlimit, nv) static one-hot rows
    lim_sign: torch.Tensor     # (B, nlimit) +-1 side
    lim_aref: torch.Tensor     # (B, nlimit)
    lim_D: torch.Tensor        # (B, nlimit)
    lim_pos: torch.Tensor      # (B, nlimit)
    con_G1: torch.Tensor       # (B, ncon, 3, 6) side-1 [r x frame | frame]
    con_G2: torch.Tensor       # (B, ncon, 3, 6) side-2
    con_chain1: np.ndarray     # (ncon, nv) static 0/1 chain mask, side 1
    con_chain2: np.ndarray     # (ncon, nv)
    con_c1: torch.Tensor       # (ncon, nv) the chain masks on the device
    con_c2: torch.Tensor
    con_cdof: torch.Tensor     # (B, nv, 6)
    con_mu: torch.Tensor       # (B, ncon, 2)
    con_aref: torch.Tensor     # (B, ncon, 4) per-facet reference acc
    con_D: torch.Tensor        # (B, ncon, 4) per-facet 1/R
    con_pos: torch.Tensor      # (B, ncon)
    nlimit: int
    ncon: int

    @property
    def nefc(self) -> int:
        return self.nlimit + 4 * self.ncon

    def replace(self, **kwargs) -> "EfcSystem":
        return dataclasses.replace(self, **kwargs)

    def jx(self, x: torch.Tensor):
        """J @ x: (lim (B, nlimit), facets (B, ncon, 4))."""
        lim = self.lim_sign * (x @ self.lim_onehot.T)
        if not self.ncon:
            return lim, x.new_zeros(x.shape[0], 0, 4)
        base = contact_products(self.con_G1, self.con_G2, self.con_c1,
                                self.con_c2, self.con_cdof * x[..., None])
        n, t1, t2 = base.unbind(-1)
        mu1, mu2 = self.con_mu[..., 0], self.con_mu[..., 1]
        return lim, torch.stack([n + mu1 * t1, n - mu1 * t1,
                                 n + mu2 * t2, n - mu2 * t2], -1)

    def jt_f(self, lim_f: torch.Tensor, con_f: torch.Tensor) -> torch.Tensor:
        """J^T @ f from per-block forces -> (B, nv)."""
        B, nv = self.con_cdof.shape[:2]
        out = self.con_cdof.new_zeros(B, nv)
        if self.nlimit:
            out = out + (self.lim_sign * lim_f) @ self.lim_onehot
        if self.ncon:
            mu1, mu2 = self.con_mu[..., 0], self.con_mu[..., 1]
            fvec = torch.stack([con_f.sum(-1),
                                mu1 * (con_f[..., 0] - con_f[..., 1]),
                                mu2 * (con_f[..., 2] - con_f[..., 3])], -1)
            t2 = torch.einsum("bcfk,bcf->bck", self.con_G2, fvec)
            t1 = torch.einsum("bcfk,bcf->bck", self.con_G1, fvec)
            u = (torch.einsum("cv,bck->bvk", self.con_c2, t2)
                 - torch.einsum("cv,bck->bvk", self.con_c1, t1))
            out = out + torch.sum(self.con_cdof * u, -1)
        return out


def contact_products(G1, G2, c1, c2, cx):
    """Contact-frame products (B, ncon, 3) of the factored Jacobian with
    per-dof spatial vectors cx (B, nv, 6) = cdof * x."""
    return (torch.einsum("bcfk,bck->bcf", G2,
                         torch.einsum("cv,bvk->bck", c2, cx))
            - torch.einsum("bcfk,bck->bcf", G1,
                           torch.einsum("cv,bvk->bck", c1, cx)))


def limit_onehot(lim_dof: np.ndarray, nv: int) -> np.ndarray:
    out = np.zeros((len(lim_dof), nv), np.float32)
    out[np.arange(len(lim_dof)), lim_dof] = 1.0
    return out


def _impedance(solimp, r):
    """MuJoCo solimp sigmoid: impedance as a function of violation |r|."""
    d0, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(torch.abs(r) / torch.clamp(width, min=1e-12), 0.0, 1.0)
    pow_ = torch.clamp(power, min=1.0)
    mid = torch.clamp(mid, 1e-4, 1.0 - 1e-4)
    y_lo = (x / mid) ** pow_ * mid
    y_hi = 1.0 - ((1.0 - x) / (1.0 - mid)) ** pow_ * (1.0 - mid)
    y = torch.where(x < mid, y_lo, y_hi)
    return torch.clamp(d0 + y * (dmax - d0), 1e-5, 1.0 - 1e-5)


def _kb(solref, solimp):
    """(k, b) of the reference acceleration; negative solref is the direct
    (-stiffness, -damping) format."""
    tc, dr = solref[..., 0], solref[..., 1]
    dmax = solimp[..., 1]
    b = 2.0 / torch.clamp(dmax * tc, min=1e-8)
    k = 1.0 / torch.clamp((dmax * tc * dr) ** 2, min=1e-12)
    direct = tc <= 0
    return (torch.where(direct, -solref[..., 0], k),
            torch.where(direct, -solref[..., 1], b))


def make_constraints(m: Model, d: Data, con_dist, con_pos, con_frame,
                     con_pair: np.ndarray) -> EfcSystem:
    """Builds the factored constraint system of the batch."""
    if m.opt.cone == int(ConeType.ELLIPTIC):
        raise NotImplementedError("elliptic cones are not ported yet")
    B = d.qpos.shape[0]
    dtype, dev = d.qpos.dtype, d.qpos.device
    flags = m.opt.disableflags
    disable_cstr = bool(flags & DisableBit.CONSTRAINT)

    lim_ids = np.nonzero(np.asarray(m.jnt_limited))[0]
    if disable_cstr or flags & DisableBit.LIMIT:
        lim_ids = lim_ids[:0]
    nlimit = len(lim_ids)
    if nlimit:
        lim_dof = np.asarray(m.jnt_dofadr[lim_ids])
        lid = m.index(lim_ids)
        q = d.qpos[:, m.index(m.jnt_qposadr[lim_ids])]
        dist_lo = q - m.jnt_range[lid, 0]
        dist_hi = m.jnt_range[lid, 1] - q
        sign = torch.where(dist_lo < dist_hi, 1.0, -1.0).to(dtype)
        pos = torch.minimum(dist_lo, dist_hi) - m.jnt_margin[lid]
        solimp = m.jnt_solimp[lid]
        imp = torch.where(pos < 0.0, _impedance(solimp, pos),
                          torch.full_like(pos, 1e-7))
        k, b = _kb(m.jnt_solref[lid], solimp)
        vel = sign * d.qvel[:, m.index(lim_dof)]
        R = torch.clamp((1.0 - imp) / imp * torch.clamp(
            m.dof_invweight0[m.index(lim_dof)], min=1e-12), min=1e-10)
        lim = dict(lim_dof=lim_dof,
                   lim_onehot=m.const(limit_onehot(lim_dof, m.nv), dtype),
                   lim_sign=sign,
                   lim_aref=-b * vel - k * imp * pos, lim_D=1.0 / R,
                   lim_pos=pos)
    else:
        z = d.qpos.new_zeros(B, 0)
        lim = dict(lim_dof=np.zeros(0, np.int32),
                   lim_onehot=d.qpos.new_zeros(0, m.nv), lim_sign=z, lim_aref=z,
                   lim_D=z, lim_pos=z)

    ncon = 0 if (disable_cstr or flags & DisableBit.CONTACT) else m.ncon_max
    if ncon:
        g1 = np.asarray(m.pair_geom1)[con_pair]
        g2 = np.asarray(m.pair_geom2)[con_pair]
        b1 = np.asarray(m.geom_bodyid)[g1]
        b2 = np.asarray(m.geom_bodyid)[g2]
        root = np.asarray(m.body_rootid)

        def side_G(body):
            r = con_pos - d.subtree_com[:, m.index(root[body])]
            rxF = vmath.cross(r[:, :, None, :], con_frame)
            return torch.cat([rxF, con_frame], -1)        # (B, ncon, 3, 6)

        G1, G2 = side_G(b1), side_G(b2)
        chain1 = np.asarray(m.body_chain_dof_mask)[b1].astype(np.float32)
        chain2 = np.asarray(m.body_chain_dof_mask)[b2].astype(np.float32)
        pair = m.index(con_pair)
        margin, gap = m.pair_margin[pair], m.pair_gap[pair]
        pos = con_dist - margin
        solimp = m.pair_solimp[pair]
        imp = torch.where(con_dist < margin - gap, _impedance(solimp, pos),
                          torch.full_like(pos, 1e-7))
        k, b = _kb(m.pair_solref[pair], solimp)
        mu1, mu2 = m.pair_friction[pair, 0], m.pair_friction[pair, 1]
        pyramid = m.const(np.asarray(m.pair_dim)[con_pair] >= 3, torch.bool)
        c1, c2 = m.const(chain1, dtype), m.const(chain2, dtype)
        base_vel = contact_products(G1, G2, c1, c2,
                                    d.cdof * d.qvel[..., None])
        nvl, t1v, t2v = base_vel.unbind(-1)
        fvel = torch.stack([nvl + mu1 * t1v, nvl - mu1 * t1v,
                            nvl + mu2 * t2v, nvl - mu2 * t2v], -1)
        con_aref = -b[:, None] * fvel - (k * imp * pos)[..., None]
        iw_sum = (m.body_invweight0[m.index(b1)]
                  + m.body_invweight0[m.index(b2)])
        mu_f = torch.stack([mu1, mu1, mu2, mu2], -1)
        diag = torch.where(pyramid[:, None],
                           iw_sum[:, None] * 2.0 * (1.0 + mu_f * mu_f),
                           iw_sum[:, None].expand(-1, 4))
        R = torch.clamp(((1.0 - imp) / imp)[..., None]
                        * torch.clamp(diag, min=1e-12), min=1e-10)
        # frictionless contacts act through facet 0 only
        facet_on = torch.cat([torch.ones(ncon, 1, dtype=dtype, device=dev),
                              pyramid[:, None].to(dtype).expand(-1, 3)], -1)
        con = dict(con_G1=G1, con_G2=G2, con_chain1=chain1,
                   con_chain2=chain2, con_c1=c1, con_c2=c2, con_cdof=d.cdof,
                   con_mu=torch.stack([mu1, mu2], -1).expand(B, ncon, 2),
                   con_aref=con_aref * facet_on, con_D=facet_on / R,
                   con_pos=pos)
    else:
        z = d.qpos.new_zeros
        con = dict(con_G1=z(B, 0, 3, 6), con_G2=z(B, 0, 3, 6),
                   con_chain1=np.zeros((0, m.nv), np.float32),
                   con_chain2=np.zeros((0, m.nv), np.float32),
                   con_c1=z(0, m.nv), con_c2=z(0, m.nv), con_cdof=d.cdof, con_mu=z(B, 0, 2), con_aref=z(B, 0, 4),
                   con_D=z(B, 0, 4), con_pos=z(B, 0))
    return EfcSystem(nlimit=nlimit, ncon=ncon, **lim, **con)
