"""Loads the port's numpy assets (see tools/export_torch_assets.py) into
torch objects.  Everything here reads plain numpy arrays; nothing of the
JAX package is imported."""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Union

import numpy as np
import torch

from vnl_tpu_torch.physics import model as model_lib

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
TWIN_MODEL = os.path.join(ASSETS, "rodent_twin_model.npz")
TWIN_CLIP = os.path.join(ASSETS, "rodent_twin_clip.npz")
BOX_CHAIN_MODEL = os.path.join(ASSETS, "box_chain_model.npz")   # nv = 7
BALL_ARM_MODEL = os.path.join(ASSETS, "ball_arm_model.npz")     # nv = 7
STAR96_MODEL = os.path.join(ASSETS, "star96_model.npz")         # nv = 96
KEEPER_POLICY = os.path.join(ASSETS, "keeper_13fcbe84_policy.npz")

Arrays = Union[str, Mapping[str, np.ndarray]]


def _arrays(src: Arrays) -> Mapping[str, np.ndarray]:
    if isinstance(src, (str, os.PathLike)):
        with np.load(src) as z:
            return {k: z[k] for k in z.files}
    return src


def _leaf_dtype(a: np.ndarray):
    if a.dtype == np.bool_:
        return torch.bool
    if np.issubdtype(a.dtype, np.integer):
        return torch.int32
    return torch.float32


def model_from_numpy(src: Arrays, device="cuda") -> model_lib.Model:
    """A torch Model from the fields of a compiled model (a .npz path or a
    mapping of numpy arrays): sizes and index tables stay numpy, leaves go
    to ``device``."""
    a = _arrays(src)
    opt = {}
    for f in dataclasses.fields(model_lib.Option):
        v = np.asarray(a[f"opt_{f.name}"])
        opt[f.name] = tuple(float(x) for x in v) if v.ndim else v.item()
    kw = {"opt": model_lib.Option(**opt)}
    for f in dataclasses.fields(model_lib.Model):
        if f.name in kw or f.name == "cache":
            continue
        v = np.asarray(a[f.name])
        if f.type == "int":
            kw[f.name] = int(v)
        elif f.type == "np.ndarray":
            kw[f.name] = v
        elif f.type == "torch.Tensor":
            kw[f.name] = torch.tensor(v, dtype=_leaf_dtype(v), device=device)
        else:                                    # name tables
            kw[f.name] = tuple(str(x) for x in v.tolist())
    return model_lib.Model(**kw)


def clip_from_numpy(src: Arrays, device="cuda"):
    """A ReferenceClip from a .npz path or a mapping of numpy arrays."""
    from vnl_tpu_torch.data.reference_clip import ReferenceClip
    a = _arrays(src)
    fields = ReferenceClip.__dataclass_fields__
    return ReferenceClip(**{k: torch.as_tensor(np.asarray(v, np.float32),
                                               device=device)
                            for k, v in a.items() if k in fields})


def policy_from_numpy(src: Arrays, device="cuda"):
    """The intention policy with the weights of a Flax parameter tree
    flattened to ``a.b.c`` keys (plus ``normalizer.mean/std``).

    Flax ``Dense.kernel`` is (in, out) and becomes ``nn.Linear.weight``
    (out, in); ``LayerNorm`` scale/bias become weight/bias (eps 1e-6, as
    Flax's default)."""
    from vnl_tpu_torch.models.intention import IntentionPolicy
    a = _arrays(src)

    def stack(prefix):
        widths = []
        while f"{prefix}.proj_{len(widths)}.kernel" in a:
            widths.append(a[f"{prefix}.proj_{len(widths)}.kernel"].shape[1])
        return widths

    traj_size = a["encoder.proj_0.kernel"].shape[0]
    latent = a["post_mean.kernel"].shape[1]
    obs_size = a["decoder.proj_0.kernel"].shape[0] - latent
    policy = IntentionPolicy(traj_size=traj_size, obs_size=obs_size,
                             encoder_widths=stack("encoder"),
                             decoder_widths=stack("decoder"),
                             latent_width=latent,
                             out_width=a["action_head.kernel"].shape[1])
    state = {}
    for key, v in a.items():
        v = torch.as_tensor(np.asarray(v, np.float32))
        if key.startswith("normalizer."):
            state["obs_" + key.split(".")[1]] = v
            continue
        parts = key.split(".")
        leaf = parts[-1]
        name = ".".join(parts[:-1])
        if leaf == "kernel":
            state[f"{name}.weight"] = v.T.contiguous()
        elif leaf == "scale":
            state[f"{name}.weight"] = v
        else:
            state[f"{name}.bias"] = v
    policy.load_state_dict(state)
    return policy.to(device)


def policy_to_numpy(policy) -> dict:
    """Inverse of :func:`policy_from_numpy` (Flax layout, ``a.b.c`` keys)."""
    out = {}
    for key, v in policy.state_dict().items():
        v = v.detach().cpu().numpy()
        if key.startswith("obs_"):
            out["normalizer." + key[4:]] = v
            continue
        name, leaf = key.rsplit(".", 1)
        is_norm = name.split(".")[-1].startswith("norm_")
        if leaf == "weight":
            out[f"{name}.{'scale' if is_norm else 'kernel'}"] = (
                v if is_norm else v.T)
        else:
            out[f"{name}.bias"] = v
    return out


def value_from_numpy(src: Arrays, device="cuda"):
    """The value MLP with the weights of a Flax parameter tree flattened to
    ``hidden_k.kernel`` / ``hidden_k.bias`` keys (kernel (in, out) becomes
    ``nn.Linear.weight`` (out, in))."""
    from vnl_tpu_torch.models.networks import MLP
    a = _arrays(src)
    sizes = []
    while f"hidden_{len(sizes)}.kernel" in a:
        sizes.append(a[f"hidden_{len(sizes)}.kernel"].shape[1])
    value = MLP(a["hidden_0.kernel"].shape[0], sizes)
    state = {}
    for key, v in a.items():
        name, leaf = key.rsplit(".", 1)
        v = torch.as_tensor(np.asarray(v, np.float32))
        state[f"{name}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
            v.T.contiguous() if leaf == "kernel" else v)
    value.load_state_dict(state)
    return value.to(device)


def value_to_numpy(value) -> dict:
    """Inverse of :func:`value_from_numpy` (Flax layout)."""
    out = {}
    for key, v in value.state_dict().items():
        name, leaf = key.rsplit(".", 1)
        v = v.detach().cpu().numpy()
        out[f"{name}.{'kernel' if leaf == 'weight' else 'bias'}"] = (
            v.T if leaf == "weight" else v)
    return out


def normalizer_from_numpy(src: Arrays, device="cuda"):
    """A RunningStatisticsState from ``count``, ``mean``,
    ``summed_variance`` and ``std`` arrays."""
    from vnl_tpu_torch.training.running_statistics import \
        RunningStatisticsState
    a = _arrays(src)
    return RunningStatisticsState(**{
        k: torch.tensor(np.asarray(a[k], np.float32), device=device)
        for k in ("count", "mean", "summed_variance", "std")})
