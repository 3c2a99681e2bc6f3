"""Builds the hand-written CUDA kernels at first use and loads them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library for ``sm_90a`` (Hopper), all sources at once
in parallel, then loaded with ctypes.  Libraries are named by the hash of
their source, so an unchanged source is not rebuilt.  The build directory
is ``build/kernels`` beside the package (override: VNL_TPU_TORCH_BUILD).
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
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
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + ARCH.encode()).hexdigest()[:12]
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
        for n, t in todo.items():
            cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-o", t + ".tmp", os.path.join(CSRC, f"{n}.cu")]
            procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
        errors = []
        for n, p in procs.items():
            log, _ = p.communicate()
            BUILD_LOG[n] = log
            if p.returncode != 0:
                errors.append(f"nvcc failed on {n}.cu:\n{log}")
            else:
                os.replace(todo[n] + ".tmp", todo[n])
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
