"""Clip file IO (PyTorch counterpart of vnl_tpu/data/io.py).

Loads clip pickles, including the legacy 13-field ``ReferenceClip`` of the
upstream preprocessing and clips pickled with jax arrays, without importing
jax or any other package the pickle names: a tolerant unpickler maps the
classes of jax, flax and vnl_tpu (and any class it cannot import) to plain
namespaces, and jax's array reducer to numpy.  Also reads STAC qpos
pickles and the port's own ``.npz`` clips (``compat.clip_from_numpy``).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from vnl_tpu_torch.data.reference_clip import ReferenceClip

# modules whose classes a pickle may name but the port never imports
_NOT_IMPORTED = ("jax", "jaxlib", "flax", "vnl_tpu")


class _Namespace:
    """Stand-in for classes we don't (want to) import."""

    def __init__(self, *args, **kwargs):
        self.__dict__.update(kwargs)
        if args:
            self.__dict__["_args"] = args

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


def _np_reconstruct(fun, args, arr_state=None, aval_state=None):
    """Replacement for jax's pickled array reducer -> plain numpy."""
    out = fun(*args)
    if arr_state is not None:
        try:
            out.__setstate__(arr_state)
        except Exception:
            pass
    return np.asarray(out)


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "_reconstruct_array":
            return _np_reconstruct
        if module.split(".")[0] not in _NOT_IMPORTED:
            try:
                return super().find_class(module, name)
            except Exception:
                pass
        return type(name, (_Namespace,), {"__module__": module})


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return _TolerantUnpickler(f).load()


_CLIP_FIELDS = ("position", "quaternion", "joints", "body_positions",
                "body_quaternions", "velocity", "joints_velocity",
                "angular_velocity", "center_of_mass", "end_effectors",
                "appendages", "markers", "scaling")


def load_clip(path: str, device="cuda") -> ReferenceClip:
    """Loads a ReferenceClip (an 8-field mjx or 13-field legacy pickle, or
    the port's .npz) with float32 leaves on ``device``."""
    if path.endswith(".npz"):
        from vnl_tpu_torch import compat
        return compat.clip_from_numpy(path, device=device)
    obj = load_pickle(path)
    d = obj if isinstance(obj, dict) else obj.__dict__
    kwargs: Dict[str, Optional[torch.Tensor]] = {}
    for f in _CLIP_FIELDS:
        v = d.get(f)
        kwargs[f] = None if v is None else torch.as_tensor(
            np.asarray(v, np.float32), device=device)
    return ReferenceClip(**kwargs)


def load_stac_qpos(path: str) -> np.ndarray:
    """Loads a STAC fit pickle and returns the qpos trajectory (T, nq)."""
    d = load_pickle(path)
    if not isinstance(d, dict):
        d = d.__dict__
    return np.asarray(d["qpos"])
