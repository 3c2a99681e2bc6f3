"""Loads the reference's numpy assets (models compiled by the JAX package,
the twin's clip; ``../assets``) into torch objects."""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Union

import numpy as np
import torch

from benchmark.reference.plain.physics import model as model_lib

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
TWIN_MODEL = os.path.join(ASSETS, "rodent_twin_model.npz")
TWIN_CLIP = os.path.join(ASSETS, "rodent_twin_clip.npz")

Arrays = Union[str, Mapping[str, np.ndarray]]


def _arrays(src: Arrays) -> Mapping[str, np.ndarray]:
    if isinstance(src, (str, os.PathLike)):
        with np.load(src) as z:
            return {k: z[k] for k in z.files}
    return src


def _leaf_dtype(a: np.ndarray, dtype=torch.float32):
    if a.dtype == np.bool_:
        return torch.bool
    if np.issubdtype(a.dtype, np.integer):
        return torch.int32
    return dtype


def model_from_numpy(src: Arrays, device="cuda",
                     dtype=torch.float32) -> model_lib.Model:
    """A torch Model from the fields of a compiled model (a .npz path or a
    mapping of numpy arrays): sizes and index tables stay numpy, leaves go
    to ``device``."""
    a = _arrays(src)
    opt = {}
    for f in dataclasses.fields(model_lib.Option):
        v = np.asarray(a[f"opt_{f.name}"])
        opt[f.name] = tuple(float(x) for x in v) if v.ndim else v.item()
    kw = {"opt": model_lib.Option(**opt)}
    if "skin_file" in a:       # written only for a model that has a skin
        kw["skin_file"] = str(a["skin_file"])
    for f in dataclasses.fields(model_lib.Model):
        if f.name in kw or f.name in ("cache", "skin_file"):
            continue
        v = np.asarray(a[f.name])
        if f.type == "int":
            kw[f.name] = int(v)
        elif f.type == "np.ndarray":
            kw[f.name] = v
        elif f.type == "torch.Tensor":
            kw[f.name] = torch.tensor(v, dtype=_leaf_dtype(v, dtype),
                                      device=device)
        else:                                    # name tables
            kw[f.name] = tuple(str(x) for x in v.tolist())
    return model_lib.Model(**kw)


def clip_from_numpy(src: Arrays, device="cuda", dtype=torch.float32):
    """A ReferenceClip from a .npz path or a mapping of numpy arrays."""
    from benchmark.reference.plain.data.reference_clip import ReferenceClip
    a = _arrays(src)
    fields = ReferenceClip.__dataclass_fields__
    return ReferenceClip(**{k: torch.as_tensor(np.asarray(v), dtype=dtype,
                                               device=device)
                            for k, v in a.items() if k in fields})
