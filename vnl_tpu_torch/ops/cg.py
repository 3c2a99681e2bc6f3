"""Kernel B: the whole CG contact solve (counterpart of
vnl_tpu/ops/pallas_cg.py).

``cg(...)`` takes the flat per-env signature of the JAX package's
make_cg_fused, batched on a leading dim:
  qM, qMinv (B, nv, nv), qacc_smooth (B, nv), cdof (B, nv, 6),
  g36 (B, 36, ncon) [G2 | G1 rows, f-major], lim_sign/aref/D (B, nlimit),
  con_mu (B, ncon, 2), con_aref/con_D (B, ncon, 4)
  -> qacc (B, nv), qfrc_constraint (B, nv), con_f (B, ncon, 4).
On CUDA tensors it launches csrc/cg.cu; on CPU tensors it runs
``cg_plain``, the port of vnl_tpu/physics/solver.py:215 _make_cg_reference
(the same solve, recomputing M(x - a) each iteration).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from vnl_tpu_torch.ops import build, launch_counts
from vnl_tpu_torch.physics import constraint, solver

THREADS = 128
_STATICS: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class CgStatics:
    """Static structure of one model's constraint system."""

    nv: int
    ncon: int
    nlimit: int
    lim_dof: np.ndarray      # (nlimit,)
    chain1: np.ndarray       # (ncon, nv) 0/1
    chain2: np.ndarray       # (ncon, nv) 0/1
    iters: int
    ls_iters: int
    cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    def make(nv, lim_dof, chain1, chain2, iters, ls_iters) -> "CgStatics":
        lim_dof = np.asarray(lim_dof, np.int32)
        chain1 = np.asarray(chain1, np.float32)
        chain2 = np.asarray(chain2, np.float32)
        key = (nv, iters, ls_iters, lim_dof.tobytes(), chain1.tobytes(),
               chain2.tobytes())
        if key not in _STATICS:
            _STATICS[key] = CgStatics(nv, chain1.shape[0], len(lim_dof),
                                      lim_dof, chain1, chain2, iters,
                                      ls_iters)
        return _STATICS[key]


def _efc(st: CgStatics, cdof, g36, lim_sign, lim_aref, lim_D, con_mu,
         con_aref, con_D) -> constraint.EfcSystem:
    B, dtype, dev = cdof.shape[0], cdof.dtype, cdof.device
    g = g36.reshape(B, 2, 3, 6, st.ncon).permute(0, 1, 4, 2, 3)
    z = lim_sign.new_zeros
    return constraint.EfcSystem(
        lim_dof=st.lim_dof,
        lim_onehot=torch.as_tensor(
            constraint.limit_onehot(st.lim_dof, st.nv), dtype=dtype,
            device=dev),
        lim_sign=lim_sign, lim_aref=lim_aref, lim_D=lim_D,
        lim_pos=z(lim_sign.shape), con_G1=g[:, 1], con_G2=g[:, 0],
        con_chain1=st.chain1, con_chain2=st.chain2,
        con_c1=torch.as_tensor(st.chain1, dtype=dtype, device=dev),
        con_c2=torch.as_tensor(st.chain2, dtype=dtype, device=dev),
        con_cdof=cdof, con_mu=con_mu, con_aref=con_aref, con_D=con_D,
        con_pos=z(B, st.ncon), nlimit=st.nlimit, ncon=st.ncon)


def cg_plain(qM, qMinv, qacc_smooth, cdof, g36, lim_sign, lim_aref, lim_D,
             con_mu, con_aref, con_D, *, statics: CgStatics):
    """Plain PyTorch CG solve (solver._cg_loop over the factored system)."""
    efc = _efc(statics, cdof, g36, lim_sign, lim_aref, lim_D, con_mu,
               con_aref, con_D)
    x, lim_jx, con_fx = solver._cg_loop(qM, qMinv, efc, qacc_smooth,
                                        statics.iters, statics.ls_iters)
    _, _, lim_f, con_f = solver._forces(efc, lim_jx, con_fx)
    return x, efc.jt_f(lim_f, con_f), con_f


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_IN = ("qM", "qMinv", "x0", "cdof", "g36", "lim_sign", "lim_aref", "lim_D",
       "con_mu", "con_aref", "con_D")


class CgModel(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("nv", "ncon", "nlimit", "iters",
                                            "ls_iters")] + \
               [("lim_dof", ctypes.c_void_p), ("chain", ctypes.c_void_p)]


class CgIn(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _IN]


class CgOut(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("qacc", "qfrc", "con_f")]


def _device_model(st: CgStatics, device: torch.device) -> CgModel:
    key = str(device)
    if key not in st.cache:
        lim = torch.as_tensor(st.lim_dof, dtype=torch.int32, device=device)
        chain = torch.as_tensor(np.stack([st.chain2, st.chain1]),
                                dtype=torch.float32, device=device)
        st.cache[key] = (CgModel(st.nv, st.ncon, st.nlimit, st.iters,
                                 st.ls_iters, lim.data_ptr(),
                                 chain.data_ptr()), (lim, chain))
    return st.cache[key][0]


def _launch(st: CgStatics, args):
    B = args[0].shape[0]
    nv, nc, nl = st.nv, st.ncon, st.nlimit
    shapes = [(nv, nv), (nv, nv), (nv,), (nv, 6), (36, nc), (nl,), (nl,),
              (nl,), (nc, 2), (nc, 4), (nc, 4)]
    dev = args[0].device
    for name, a, s in zip(_IN, args, shapes):
        if (a.dtype != torch.float32 or tuple(a.shape) != (B,) + s
                or not a.is_contiguous() or a.device != dev):
            raise ValueError(f"kernel B: {name} must be contiguous float32 "
                             f"{(B,) + s} on {dev}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if nl == 0 or nc == 0:
        raise ValueError("kernel B needs at least one limit row and one "
                         "contact")
    lib = build.load("cg")
    fn = lib.cg_launch
    fn.argtypes = [CgModel, CgIn, CgOut, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    qacc = torch.empty(B, nv, device=dev)
    qfrc = torch.empty(B, nv, device=dev)
    con_f = torch.empty(B, nc, 4, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_device_model(st, dev), CgIn(*[a.data_ptr() for a in args]),
             CgOut(qacc.data_ptr(), qfrc.data_ptr(), con_f.data_ptr()), B,
             THREADS, stream)
    build.check(err, "kernel B (cg)")
    launch_counts["cg"] += 1
    return qacc, qfrc, con_f


def cg(qM, qMinv, qacc_smooth, cdof, g36, lim_sign, lim_aref, lim_D,
       con_mu, con_aref, con_D, *, statics: CgStatics):
    """The CG solve of a batch: kernel B on CUDA tensors, the plain version
    on CPU tensors."""
    args = (qM, qMinv, qacc_smooth, cdof, g36, lim_sign, lim_aref, lim_D,
            con_mu, con_aref, con_D)
    if qM.is_cuda:
        return _launch(statics, args)
    if qM.device.type != "cpu":
        raise ValueError(f"no CG solve for device {qM.device}")
    return cg_plain(*args, statics=statics)
