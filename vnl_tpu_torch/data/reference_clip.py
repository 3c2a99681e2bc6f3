"""Reference trajectory containers (PyTorch counterpart of
vnl_tpu/data/reference_clip.py): ``ReferenceClip`` holds the per-frame
mocap features of one clip (leading axis = frames); ``ClipLibrary`` stacks
clips for the multi-clip env."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

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


@dataclasses.dataclass(frozen=True, eq=False)
class ClipLibrary:
    """Stacked clips, leaves (C, T, ...), with id-indexed gathers: each env
    of a batch can track its own clip of one shared library tensor."""

    clips: ReferenceClip                       # stacked, (C, T, ...)
    weights: Optional[torch.Tensor] = None     # (C,) sampling weights

    @property
    def num_clips(self) -> int:
        return self.clips.position.shape[0]

    @property
    def clip_length(self) -> int:
        return self.clips.position.shape[1]

    def view(self, clip_id: torch.Tensor) -> "ClipView":
        """Each env's own clip, for the (B,) ids ``clip_id``."""
        return ClipView(self.clips, clip_id)

    def get(self, clip_id) -> ReferenceClip:
        """The clip of an id (leaves (T, ...)), or of each of a (B,) tensor
        of ids (leaves (B, T, ...))."""
        return dataclasses.replace(self.clips, **{
            f.name: getattr(self.clips, f.name)[clip_id]
            for f in dataclasses.fields(self.clips)
            if getattr(self.clips, f.name) is not None})

    def sample_id(self, batch: int,
                  generator: Optional[torch.Generator] = None,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(batch,) clip ids: categorical in ``weights`` (else the
        library's), uniform when neither is given."""
        w = self.weights if weights is None else weights
        dev = self.clips.position.device
        if w is None:
            return torch.randint(0, self.num_clips, (batch,),
                                 generator=generator, device=dev)
        return torch.multinomial(torch.as_tensor(w, dtype=torch.float32,
                                                 device=dev),
                                 batch, replacement=True,
                                 generator=generator)

    @classmethod
    def from_clips(cls, clips: Sequence[ReferenceClip],
                   weights: Optional[torch.Tensor] = None) -> "ClipLibrary":
        first = clips[0]
        stacked = dataclasses.replace(first, **{
            f.name: torch.stack([getattr(c, f.name) for c in clips])
            for f in dataclasses.fields(first)
            if getattr(first, f.name) is not None})
        return cls(clips=stacked, weights=weights)


@dataclasses.dataclass(frozen=True, eq=False)
class ClipView:
    """The clips of a batch of envs, one library clip each: ``at`` and
    ``slice`` as ReferenceClip's, gathering each env's clip at each env's
    frame."""

    clips: ReferenceClip          # stacked, (C, T, ...)
    clip_id: torch.Tensor         # (B,)

    def _gather(self, frames: torch.Tensor) -> ReferenceClip:
        """Leaves x[clip_id, frames] for (B,) or (B, L) frame indices."""
        T = self.clips.position.shape[1]
        ids = self.clip_id.long().reshape(
            (-1,) + (1,) * (frames.dim() - 1))
        return dataclasses.replace(self.clips, **{
            f.name: getattr(self.clips, f.name)[ids, frames]
            for f in dataclasses.fields(self.clips)
            if getattr(self.clips, f.name) is not None
            and getattr(self.clips, f.name).dim() >= 2
            and getattr(self.clips, f.name).shape[1] == T})

    def at(self, frame: torch.Tensor) -> ReferenceClip:
        T = self.clips.position.shape[1]
        return self._gather(torch.clamp(frame.long(), 0, T - 1))

    def slice(self, start: torch.Tensor, length: int) -> ReferenceClip:
        T = self.clips.position.shape[1]
        s = torch.clamp(start.long(), 0, T - length)
        return self._gather(s[:, None] + torch.arange(length,
                                                      device=s.device))
