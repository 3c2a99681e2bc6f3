"""Kernel F: GAE's TD(lambda) value targets and advantages over an unroll
in one launch.

``compute_gae`` is the learner's GAE (training/losses.py).  On a CUDA
device it launches csrc/gae.cu on the [T, B] inputs as they lie, strided
views included, and returns what ``compute_gae_plain``, the plain
version, returns everywhere else: targets and advantages, [T, B] float32
and contiguous.  The kernel rounds each operation on its own, as the
plain version's separate PyTorch operations do, so both give the same
bits.
"""

from __future__ import annotations

import ctypes

import torch

from vnl_tpu_torch.ops import build

THREADS = 128       # kThreads of the source: one thread a column b
# the [T, B] inputs, in the order of the source's GaeIn
SEQ_NAMES = ("truncation", "termination", "rewards", "values")


@torch.no_grad()
def compute_gae_plain(truncation, termination, rewards, values,
                      bootstrap_value, lambda_: float = 1.0,
                      discount: float = 0.99):
    """TD(lambda) value targets and advantages over [T, B] tensors, without
    gradients.  Truncated steps contribute nothing (mask); terminated steps
    cut the discounted continuation."""
    mask = 1.0 - truncation
    cont = discount * (1.0 - termination)
    next_values = torch.cat([values[1:], bootstrap_value[None]], 0)
    deltas = rewards + cont * next_values - values
    gae = torch.zeros_like(bootstrap_value)
    lambda_returns, advantages = [], []
    for t in range(values.shape[0] - 1, -1, -1):
        advantages.append(mask[t] * (deltas[t] + cont[t] * gae))
        gae = mask[t] * (deltas[t] + lambda_ * cont[t] * gae)
        lambda_returns.append(gae)
    targets = torch.stack(lambda_returns[::-1]) + values
    return targets, torch.stack(advantages[::-1])


class Seq(ctypes.Structure):
    """A [T, B] input: element (t, b) at p[t * st + b * sb]."""
    _fields_ = [("p", ctypes.c_void_p), ("st", ctypes.c_longlong),
                ("sb", ctypes.c_longlong)]


class GaeIn(ctypes.Structure):
    _fields_ = [(n, Seq) for n in SEQ_NAMES] + [
        ("bootstrap", ctypes.c_void_p), ("bootstrap_sb", ctypes.c_longlong)]


class GaeOut(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in ("targets", "advantages")]


def kernel_inputs(truncation, termination, rewards, values,
                  bootstrap_value) -> GaeIn:
    """The inputs as the kernel reads them: each tensor's address (its
    storage offset included) and element strides."""
    return GaeIn(*[Seq(x.data_ptr(), *x.stride())
                   for x in (truncation, termination, rewards, values)],
                 bootstrap_value.data_ptr(), bootstrap_value.stride(0))


def resources() -> dict:
    """Registers per thread, local (spill) bytes, shared memory per block
    and resident blocks per SM of kernel F."""
    return dict(build.resources("gae"), threads=THREADS)


_ARGTYPES = (GaeIn, GaeOut, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_float)


def _launch(truncation, termination, rewards, values, bootstrap_value,
            lambda_: float, discount: float):
    """Kernel F on [T, B] float32 tensors of one CUDA device: (targets,
    advantages)."""
    T, B, dev = values.shape[0], bootstrap_value.shape[0], values.device
    build.check_inputs("gae", dev, (T, B),
                       *((n, x, ()) for n, x in zip(SEQ_NAMES, (
                           truncation, termination, rewards, values))),
                       strided=True)
    build.check_inputs("gae", dev, (B,),
                       ("bootstrap_value", bootstrap_value, ()),
                       strided=True)
    targets = torch.empty(T, B, device=dev)
    advantages = torch.empty(T, B, device=dev)
    build.launch("gae", _ARGTYPES, dev,
                 kernel_inputs(truncation, termination, rewards, values,
                               bootstrap_value),
                 GaeOut(targets.data_ptr(), advantages.data_ptr()),
                 T, B, lambda_, discount)
    return targets, advantages


def compute_gae(truncation, termination, rewards, values, bootstrap_value,
                lambda_: float = 1.0, discount: float = 0.99):
    """TD(lambda) value targets and advantages over [T, B] tensors, without
    gradients: kernel F on CUDA tensors, the plain version elsewhere."""
    if values.is_cuda:
        return _launch(truncation, termination, rewards, values,
                       bootstrap_value, lambda_, discount)
    return compute_gae_plain(truncation, termination, rewards, values,
                             bootstrap_value, lambda_, discount)
