"""Builds the hand-written CUDA kernels at first use, loads and launches
them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library for ``sm_90a`` (Hopper), all sources at once
in parallel, then loaded with ctypes.  Libraries are named by the hash of
their source and of the headers beside it (``csrc/*.cuh``), so an
unchanged source is not rebuilt.  The build directory
is ``build/kernels`` beside the package (override: VNL_TPU_TORCH_BUILD).
Nothing here runs at import time: the CPU tests import every module.

The wrappers share ``tables`` (a kernel's device tables, made once per
owner and device), ``check_inputs`` and ``launch`` (typed once a library,
on the current stream, checked and counted in ``launch_counts``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from vnl_tpu_torch.ops import KERNELS, launch_counts

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = {k.name: k.flags for k in KERNELS.values() if k.flags}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[str, Callable] = {}    # <name>_launch, typed
BUILD_LOG: Dict[str, str] = {}   # ptxas resource report per kernel source


def build_dir() -> str:
    return os.environ.get("VNL_TPU_TORCH_BUILD",
                          os.path.join(os.path.dirname(_PKG), "build",
                                       "kernels"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "vnl_tpu_torch are built on a machine with the "
                           "CUDA toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> str:
    h = hashlib.sha256()
    for f in [f"{name}.cu"] + sorted(f for f in os.listdir(CSRC)
                                     if f.endswith(".cuh")):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join((ARCH,) + FLAGS.get(name, ())).encode())
    digest = h.hexdigest()[:12]
    return os.path.join(build_dir(), f"lib{name}-{digest}.so")


def build_all() -> Dict[str, str]:
    """Compiles every kernel source that has no library yet, one nvcc per
    source, all started together.  Returns {name: library path}."""
    names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    os.makedirs(build_dir(), exist_ok=True)
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not os.path.exists(t)}
    if todo:
        nvcc = _nvcc()
        procs = {}
        # a temporary of this process's own: the ranks of a data-parallel
        # launch may build the same library at once
        tmp = f".{os.getpid()}.tmp"
        for n, t in todo.items():
            cmd = [nvcc, ARCH, *FLAGS.get(n, ()), "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-o", t + tmp, os.path.join(CSRC, f"{n}.cu")]
            procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
        errors = []
        for n, p in procs.items():
            log, _ = p.communicate()
            BUILD_LOG[n] = log
            if p.returncode != 0:
                errors.append(f"nvcc failed on {n}.cu:\n{log}")
            else:
                os.replace(todo[n] + tmp, todo[n])
        if errors:
            raise RuntimeError("\n".join(errors))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(build_all()[name])
        return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raises on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def resources(name: str, *args) -> dict:
    """What ``<name>_resources`` of a kernel library reports for one launch
    shape (``args``: the structs and the ints its launch takes):
    registers per thread, local-memory bytes per thread (non-zero means a
    stack frame or spills), shared memory per block and the resident blocks
    per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    fn = getattr(load(name), f"{name}_resources")
    fn.argtypes = ([type(a) if isinstance(a, ctypes.Structure)
                    else ctypes.c_int for a in args]
                   + [ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    check(fn(*args, out), f"{name}_resources")
    return dict(regs=out[0], local_bytes=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3])



def tables(owner, name: str, device, make: Callable, *key):
    """``make(device)`` -> (value, tensors the value points into), made
    once per ``owner`` (a Model, or kernel B's CgStatics), kernel
    ``name``, device and ``key`` and held in ``owner.cache``; returns the
    value."""
    k = (name, str(device)) + key
    if k not in owner.cache:
        owner.cache[k] = make(torch.device(device))
    return owner.cache[k][0]


def on_device(arrays: dict, device, dtype=None) -> dict:
    """numpy arrays or tensors as contiguous tensors on ``device``, cast
    to the numpy ``dtype`` where one is given."""
    out = {}
    for n, a in arrays.items():
        a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
        out[n] = torch.as_tensor(np.ascontiguousarray(
            a if dtype is None else a.astype(dtype)), device=device)
    return out


def check_inputs(name: str, device, lead: Sequence[int], *inputs) -> None:
    """Raises ValueError unless each (input name, tensor, trailing shape)
    of ``inputs`` is a contiguous float32 tensor of shape lead + trailing
    on ``device``."""
    for what, a, shape in inputs:
        want = tuple(lead) + tuple(shape)
        if (a.dtype != torch.float32 or tuple(a.shape) != want
                or not a.is_contiguous() or a.device != device):
            raise ValueError(
                f"kernel {KERNELS[name].letter}: {what} must be contiguous "
                f"float32 {want} on {device}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}"
                f"{'' if a.is_contiguous() else ', strided'}")


def launch(name: str, argtypes, device, *args, skip=None) -> None:
    """Calls ``<name>_launch`` of csrc/<name>.cu with ``args`` (of the
    ctypes ``argtypes``), the current stream of ``device`` and, where
    given, the profiling ``skip`` bits; raises on a CUDA error and counts
    the launch."""
    kernel = KERNELS[name]
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{kernel.label} runs on a CUDA device, got "
                         f"{device}")
    if name not in _FUNCTIONS:
        fn = getattr(load(name), f"{name}_launch")
        fn.argtypes = list(argtypes) + [ctypes.c_void_p] + (
            [] if skip is None else [ctypes.c_int])
        fn.restype = ctypes.c_int
        _FUNCTIONS[name] = fn
    stream = torch.cuda.current_stream(device).cuda_stream
    tail = (stream,) if skip is None else (stream, skip)
    with torch.cuda.device(device):
        check(_FUNCTIONS[name](*args, *tail), kernel.label)
    launch_counts[name] += 1
