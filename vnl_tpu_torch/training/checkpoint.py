"""Full-state checkpoints with resume (PyTorch counterpart of
vnl_tpu/training/checkpoint.py).

A checkpoint is one ``<step>.npz`` file in the flattened Flax layout of
``compat.training_state_to_numpy``: parameters, Adam's moments and step
count, the observation normaliser and ``env_steps``.  A JAX checkpoint
flattened by ``tools/export_torch_assets.py --checkpoint`` has the same
layout, so it resumes through the same :func:`restore`.  Params files
(``save_params``) hold the policy in the layout ``compat.policy_from_numpy``
reads.
"""

from __future__ import annotations

import logging
import os
import threading
import traceback
from typing import Mapping, Optional, Tuple

import numpy as np

from vnl_tpu_torch import compat


def _write(path: str, arrays: Mapping[str, np.ndarray]) -> str:
    """Writes ``arrays`` to exactly ``path`` (through a temporary name, so
    a reader never sees half a file)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def _checkpoint_path(checkpoint_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), f"{int(step)}.npz")


def save(checkpoint_dir: str, step: int, training_state) -> str:
    """Saves the full TrainingState; returns the checkpoint's path."""
    return _write(_checkpoint_path(checkpoint_dir, step),
                  compat.training_state_to_numpy(training_state))


_pending_save: Optional[threading.Thread] = None


def save_async(checkpoint_dir: str, step: int, training_state) -> None:
    """Saves on a background thread, so the disk write overlaps the next
    training interval.  The host copies are taken here, before the thread
    starts: the state's tensors are the live ones that the next interval
    updates in place.  At most one save is in flight; a new save joins the
    previous one first."""
    global _pending_save
    arrays = compat.training_state_to_numpy(training_state)
    path = _checkpoint_path(checkpoint_dir, step)
    wait_for_pending_saves()

    def _run():
        try:
            _write(path, arrays)
        except Exception:  # surfaced through the log, not raised
            logging.error("async checkpoint save at step %s failed:\n%s",
                          step, traceback.format_exc())

    _pending_save = threading.Thread(target=_run, daemon=True,
                                     name=f"ckpt-save-{step}")
    _pending_save.start()


def wait_for_pending_saves() -> None:
    """Joins the in-flight async save, if any (call before exit)."""
    global _pending_save
    if _pending_save is not None:
        _pending_save.join()
        _pending_save = None


def restore(path: str, device="cuda"):
    """The TrainingState of a checkpoint file, its tensors on ``device``."""
    return compat.training_state_from_numpy(path, device=device)


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """The checkpoint of the highest step in a directory, or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    steps = [int(name[:-4]) for name in os.listdir(checkpoint_dir)
             if name.endswith(".npz") and name[:-4].isdigit()]
    if not steps:
        return None
    return _checkpoint_path(checkpoint_dir, max(steps))


def _params_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_params(path: str, params: Tuple) -> str:
    """Saves ``(normalizer_params, policy_state_dict)`` as the policy's
    weights and observation normaliser in the layout of
    ``compat.policy_from_numpy`` (``.npz`` is appended when missing)."""
    return _write(_params_path(path),
                  compat.policy_state_to_numpy(params[1]))


def load_params(path: str, device="cuda"):
    """The IntentionPolicy saved by :func:`save_params`, on ``device``."""
    return compat.policy_from_numpy(_params_path(path), device=device)


def load_policy(path: str, device="cuda"):
    """The IntentionPolicy of a params file (:func:`save_params`) or of a
    full-state checkpoint (:func:`save`, or a JAX one flattened by the
    exporter), read through :func:`restore`, with the checkpoint's
    normaliser as the policy's; returns (policy, env_steps), env_steps
    None for a params file."""
    with np.load(path) as z:
        is_state = "env_steps" in z.files
    if not is_state:
        return load_params(path, device=device), None
    ts = restore(path, device=device)
    state = dict(ts.params["policy"], obs_mean=ts.normalizer_params.mean,
                 obs_std=ts.normalizer_params.std)
    return compat.policy_from_numpy(compat.policy_state_to_numpy(state),
                                    device=device), int(ts.env_steps)
