"""Multi-clip preprocessing pipeline (PyTorch counterpart of
vnl_tpu/data/pipeline.py): chunk a long STAC recording into fixed-length
clips, process them in one batch, bundle them as a ClipLibrary, and
round-trip the h5 layout (clip_N/walkers/walker_0/<feature>) and clip
pickles.

The JAX package vmaps one clip's processing over the clips; the port runs
clips x frames as one batch of its kinematics.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from vnl_tpu_torch.data.preprocess import extract_features, with_velocities
from vnl_tpu_torch.data.reference_clip import ClipLibrary, ReferenceClip
from vnl_tpu_torch.physics.model import Model


@dataclasses.dataclass
class ClipCollection:
    """Mocap clip curriculum metadata."""

    ids: Sequence[str]
    start_steps: Optional[Sequence[int]] = None
    end_steps: Optional[Sequence[int]] = None
    weights: Optional[Sequence[Union[int, float]]] = None

    def __post_init__(self):
        n = len(self.ids)
        if self.start_steps is None:
            self.start_steps = (0,) * n
        if self.weights is None:
            self.weights = (1.0,) * n
        if len(self.start_steps) != n or (
                self.end_steps is not None and len(self.end_steps) != n) or \
                len(self.weights) != n:
            raise ValueError("ClipCollection validation failed.")
        if np.any(np.asarray(self.weights) < 0):
            raise ValueError("ClipCollection weights must be >= 0")


def process_recording(model: Model, qpos_recording,
                      clip_length: int = 250, max_qvel: float = 20.0,
                      dt: float = 0.02, adjust_z_offset: float = 0.0,
                      clip_to_joint_range: bool = True,
                      legacy_features: bool = True) -> ClipLibrary:
    """Chunks a (T, nq) recording into clips and processes them as one
    batch, on the model's device.  As in the upstream legacy pipeline:
    - joint angles clipped to the model's joint ranges;
    - com / end-effector / appendage per-frame features;
    - with ``adjust_z_offset``, the floor aligned per clip: the mean of the
      10 lowest feet heights minus the foot geom's 6 mm, taken off qpos z,
      the com and the body positions.
    """
    q = torch.as_tensor(np.asarray(qpos_recording, np.float32),
                        device=model.device)
    n_clips = q.shape[0] // clip_length
    q = q[:n_clips * clip_length].reshape(n_clips, clip_length, -1)
    if clip_to_joint_range:
        # hinge rows of jnt_range follow the free root (nq = 7 + njnt - 1)
        rng = model.jnt_range[1:]
        q = torch.cat([q[..., :7],
                       torch.clamp(q[..., 7:], rng[:, 0], rng[:, 1])], -1)
    clip = extract_features(model, q, legacy_features=legacy_features)
    feet = [model.body_names.index(b) for b in ("foot_L", "foot_R")
            if b in model.body_names]
    if adjust_z_offset and feet:
        z = clip.body_positions[:, :, model.index(feet), 2]
        lowest = -torch.topk(-z.reshape(n_clips, -1), 10, dim=-1).values
        z_off = (lowest.mean(-1) - 0.006)[:, None]
        clip = clip.replace(
            position=_add_z(clip.position, -z_off),
            body_positions=_add_z(clip.body_positions, -z_off[..., None]))
        if clip.center_of_mass is not None:
            clip = clip.replace(
                center_of_mass=_add_z(clip.center_of_mass, -z_off))
    clips = with_velocities(clip, q, dt, max_qvel)
    return ClipLibrary(clips=clips, weights=torch.ones(
        n_clips, dtype=torch.float32, device=model.device))


def _add_z(x: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[..., 2] += dz
    return x


def _host(clip: ReferenceClip) -> Dict[str, Optional[np.ndarray]]:
    return {f.name: (None if getattr(clip, f.name) is None
                     else getattr(clip, f.name).detach().cpu().numpy())
            for f in dataclasses.fields(clip)}


def save_clip_pickle(path: str, clip: ReferenceClip) -> str:
    """Pickles a clip as a dict of plain numpy leaves (loadable anywhere,
    by either package's load_clip)."""
    with open(path, "wb") as f:
        pickle.dump(_host(clip), f)
    return path


def save_features_h5(path: str, library: ClipLibrary,
                     dt: float = 0.02) -> str:
    """Writes the upstream h5 layout: clip_N/walkers/walker_0/<feature>
    with (time-last) transposed arrays."""
    import h5py
    with h5py.File(path, "w") as f:
        for i in range(library.num_clips):
            clip = _host(library.get(i))
            name = f"clip_{i}"
            grp = f.create_group(name)
            n_steps = clip["position"].shape[0]
            grp.attrs["num_steps"] = n_steps
            grp.attrs["dt"] = dt
            f.create_group(f"/{name}/walkers")
            f.create_group(f"/{name}/props")
            wg = f.create_group(f"/{name}/walkers/walker_0")
            for field, v in clip.items():
                if v is None:
                    continue
                if v.ndim == 3:
                    wg[field] = np.transpose(v, (1, 2, 0)).reshape(
                        -1, n_steps)
                elif v.ndim == 2:
                    wg[field] = np.swapaxes(v, 0, 1)
                else:
                    wg[field] = v
    return path


def load_features_h5(path: str, device="cuda") -> ClipLibrary:
    """Reads the h5 layout back into a ClipLibrary on ``device`` (inverse
    of save_features_h5, with the JAX package's shape rules)."""
    import h5py
    clips = []
    valid = {fl.name for fl in dataclasses.fields(ReferenceClip)}
    with h5py.File(path, "r") as f:
        names = sorted([k for k in f.keys() if k.startswith("clip_")],
                       key=lambda s: int(s.split("_")[1]))
        for name in names:
            wg = f[f"{name}/walkers/walker_0"]
            n_steps = int(f[name].attrs["num_steps"])
            kwargs: Dict[str, np.ndarray] = {}
            for k in wg.keys():
                v = np.asarray(wg[k])
                if v.ndim == 2 and v.shape[1] == n_steps and \
                        v.shape[0] % 3 == 0 and v.shape[0] > 12:
                    # (flat, T) <- (T, n, 3)
                    kwargs[k] = np.transpose(
                        v.reshape(-1, 3 if k != "body_quaternions" else 4,
                                  n_steps), (2, 0, 1))
                elif v.ndim == 2:
                    kwargs[k] = np.swapaxes(v, 0, 1)
                else:
                    kwargs[k] = v
            clips.append(ReferenceClip(**{
                k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for k, v in kwargs.items() if k in valid}))
    return ClipLibrary.from_clips(clips)
