"""Reference trajectory containers (PyTorch counterpart of
vnl_tpu/data/reference_clip.py): ``ReferenceClip`` holds the per-frame
mocap features of one clip (leading axis = frames)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class ReferenceClip:
    position: Optional[torch.Tensor] = None          # (T, 3) root position
    quaternion: Optional[torch.Tensor] = None        # (T, 4) root orientation
    joints: Optional[torch.Tensor] = None            # (T, nq-7)
    body_positions: Optional[torch.Tensor] = None    # (T, nbody*, 3)
    body_quaternions: Optional[torch.Tensor] = None  # (T, nbody*, 4)
    velocity: Optional[torch.Tensor] = None          # (T, 3)
    joints_velocity: Optional[torch.Tensor] = None   # (T, nq-7)
    angular_velocity: Optional[torch.Tensor] = None  # (T, 3)
    center_of_mass: Optional[torch.Tensor] = None    # (T, 3)
    end_effectors: Optional[torch.Tensor] = None     # (T, n_eff, 3)
    appendages: Optional[torch.Tensor] = None        # (T, n_app, 3)
    markers: Optional[torch.Tensor] = None
    scaling: Optional[torch.Tensor] = None

    @property
    def num_frames(self) -> int:
        return self.position.shape[0]

    def replace(self, **kwargs) -> "ReferenceClip":
        return dataclasses.replace(self, **kwargs)

    def _map(self, fn) -> "ReferenceClip":
        T = self.num_frames
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
            and getattr(self, f.name).dim() >= 1
            and getattr(self, f.name).shape[0] == T})

    def at(self, frame: torch.Tensor) -> "ReferenceClip":
        """Per-env frames (B,) -> leaves (B, ...); indices are clamped to
        the clip, as a JAX gather clamps them."""
        idx = torch.clamp(frame.long(), 0, self.num_frames - 1)
        return self._map(lambda x: x[idx])

    def slice(self, start: torch.Tensor, length: int) -> "ReferenceClip":
        """Per-env windows [start, start + length) -> leaves (B, length, ...);
        the start is clamped so the window fits, as dynamic_slice does."""
        s = torch.clamp(start.long(), 0, self.num_frames - length)
        idx = s[:, None] + torch.arange(length, device=s.device)
        return self._map(lambda x: x[idx])
