"""Loads the port's numpy assets (see tools/export_torch_assets.py) into
torch objects and writes torch objects back in the same layouts: models,
clips, the policy and value weights in Flax's flattened layout, and the
full training state of a checkpoint.  Everything here reads and writes
plain numpy arrays; nothing of the JAX package is imported."""

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
# third-party scenes, copied verbatim (assets/LICENSES.md)
DM_HUMANOID_XML = os.path.join(ASSETS, "dm_humanoid", "humanoid.xml")
GYM_ANT_XML = os.path.join(ASSETS, "gym_ant.xml")
CMU_HUMANOID_XML = os.path.join(ASSETS, "dm_cmu_humanoid", "cmu_humanoid.xml")


def asset_path(path: str) -> str:
    """``path`` where it names a file from the working directory, else the
    file of that name under ASSETS: a scene that a configuration file names
    (``dm_cmu_humanoid/cmu_humanoid.xml``) is found from any working
    directory."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    return os.path.join(ASSETS, path)

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


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor (never a view of a live CPU tensor)."""
    return t.detach().to("cpu", copy=True).numpy()


def flax_key(name: str) -> str:
    """The Flax parameter key of a torch parameter name:
    ``<module>.weight`` -> ``.kernel`` (``.scale`` for a LayerNorm,
    ``norm_k``), ``.bias`` -> ``.bias``."""
    module, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        leaf = ("scale" if module.split(".")[-1].startswith("norm_")
                else "kernel")
    return f"{module}.{leaf}"


def to_flax(name: str, v: np.ndarray) -> np.ndarray:
    """A torch parameter's value in Flax's layout: an ``nn.Linear.weight``
    (out, in) becomes a kernel (in, out)."""
    return v.T if flax_key(name).endswith(".kernel") else v


def from_flax(key: str, v) -> torch.Tensor:
    """The inverse of :func:`to_flax`, as a float32 tensor."""
    v = torch.tensor(np.asarray(v, np.float32))
    return v.T.contiguous() if key.endswith(".kernel") else v


def torch_name(key: str) -> str:
    """The torch parameter name of a Flax key (inverse of flax_key)."""
    module, leaf = key.rsplit(".", 1)
    return f"{module}.{'bias' if leaf == 'bias' else 'weight'}"


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
        if key.startswith("normalizer."):
            state["obs_" + key.split(".")[1]] = from_flax(key, v)
        else:
            state[torch_name(key)] = from_flax(key, v)
    policy.load_state_dict(state)
    return policy.to(device)


def policy_state_to_numpy(state: Mapping[str, torch.Tensor]) -> dict:
    """A policy state_dict in the Flax layout of :func:`policy_from_numpy`:
    ``a.b.c`` keys, the observation normaliser as ``normalizer.mean/std``."""
    out = {}
    for key, v in state.items():
        if key.startswith("obs_"):
            out["normalizer." + key[4:]] = _host(v)
        else:
            out[flax_key(key)] = to_flax(key, _host(v))
    return out


def policy_to_numpy(policy) -> dict:
    """Inverse of :func:`policy_from_numpy` (Flax layout, ``a.b.c`` keys)."""
    return policy_state_to_numpy(policy.state_dict())


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
    value.load_state_dict({torch_name(k): from_flax(k, v)
                           for k, v in a.items()})
    return value.to(device)


def value_to_numpy(value) -> dict:
    """Inverse of :func:`value_from_numpy` (Flax layout)."""
    return {flax_key(k): to_flax(k, _host(v))
            for k, v in value.state_dict().items()}


def normalizer_from_numpy(src: Arrays, device="cuda"):
    """A RunningStatisticsState from ``count``, ``mean``,
    ``summed_variance`` and ``std`` arrays."""
    from vnl_tpu_torch.training.running_statistics import \
        RunningStatisticsState
    a = _arrays(src)
    return RunningStatisticsState(**{
        k: torch.tensor(np.asarray(a[k], np.float32), device=device)
        for k in ("count", "mean", "summed_variance", "std")})


# A checkpoint of the port is one .npz in this flattened Flax layout, the
# layout of a JAX TrainingState flattened by tools/export_torch_assets.py:
#   env_steps                               int64 ()
#   normalizer.{count,mean,summed_variance,std}
#   params.{policy,value}.<flax key>        e.g. params.value.hidden_0.kernel
#   optimizer.count                         int64 () (optax count, Adam step)
#   optimizer.{mu,nu}.{policy,value}.<flax key>
# The policy's copy of the normaliser (its obs_mean / obs_std buffers) is
# not stored: the trainer sets it from ``normalizer`` when it normalises.
_NORMALIZER = ("count", "mean", "summed_variance", "std")
_NETS = ("policy", "value")


def training_state_to_numpy(ts) -> dict:
    """A TrainingState of the port as numpy copies in the checkpoint
    layout above.  ``ts.optimizer_state`` holds Adam's ``step`` and its
    moments ``exp_avg`` / ``exp_avg_sq`` by parameter name of the network
    bundle (``policy.encoder.proj_0.weight``)."""
    out = {"env_steps": np.asarray(int(ts.env_steps), np.int64),
           "optimizer.count": np.asarray(int(ts.optimizer_state["step"]),
                                         np.int64)}
    for k in _NORMALIZER:
        out[f"normalizer.{k}"] = _host(getattr(ts.normalizer_params, k))
    for net in _NETS:
        for k, v in ts.params[net].items():
            if not k.startswith("obs_"):
                out[f"params.{net}.{flax_key(k)}"] = to_flax(k, _host(v))
    for moment, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for name, v in ts.optimizer_state[torch_key].items():
            net, k = name.split(".", 1)
            out[f"optimizer.{moment}.{net}.{flax_key(k)}"] = to_flax(
                k, _host(v))
    return out


def training_state_from_numpy(src: Arrays, device="cuda"):
    """A TrainingState of the port from a checkpoint in the layout above
    (the port's own, or a JAX one flattened by the exporter): each Flax
    kernel (in, out) becomes an ``nn.Linear.weight`` (out, in), for the
    parameters and for both Adam moments, and optax's ``count`` becomes
    Adam's ``step``."""
    from vnl_tpu_torch.training.running_statistics import \
        RunningStatisticsState
    from vnl_tpu_torch.training.train import TrainingState
    a = _arrays(src)
    params = {net: {} for net in _NETS}
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    for key, v in a.items():
        parts = key.split(".", 3)
        if parts[0] == "params":
            params[parts[1]][torch_name(".".join(parts[2:]))] = \
                from_flax(key, v).to(device)
        elif parts[0] == "optimizer" and parts[1] in ("mu", "nu"):
            moment = "exp_avg" if parts[1] == "mu" else "exp_avg_sq"
            moments[moment][f"{parts[2]}.{torch_name(parts[3])}"] = \
                from_flax(key, v).to(device)
    normalizer = RunningStatisticsState(**{
        k: torch.tensor(np.asarray(a[f"normalizer.{k}"], np.float32),
                        device=device) for k in _NORMALIZER})
    return TrainingState(
        optimizer_state=dict(step=int(a["optimizer.count"]), **moments),
        params=params, normalizer_params=normalizer,
        env_steps=int(a["env_steps"]))
