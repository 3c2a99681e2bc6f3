"""Mocap preprocessing: a recording -> a clip library -> h5 (PyTorch
counterpart of examples/process_clips.py, on the rodent twin).

Chunks a qpos recording into 125-frame clips, extracts the FK features of
all clips as one batch on the device (``process_recording``), prints the
per-clip speed and root height to help pick good clips to imitate, and
saves the library in the reference h5 layout (``save_features_h5``).  The
recording is a STAC pickle's qpos (``load_stac_qpos``), or by default the
committed twin clip's qpos; the walker is the committed twin
(vnl_tpu_torch/assets/rodent_twin.xml).  Runs on ``cuda`` unless
``--device cpu``.

  python -m vnl_tpu_torch.examples.process_clips [stac_path.p] [out.h5]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from vnl_tpu_torch import compat, mjcf
from vnl_tpu_torch.data import (load_clip, load_stac_qpos, process_recording,
                                save_features_h5)

TWIN_XML = os.path.join(compat.ASSETS, "rodent_twin.xml")


def main(stac_path=None, out=os.path.join(tempfile.gettempdir(), "clips.h5"),
         device="cuda"):
    """Returns (the ClipLibrary, the h5 path)."""
    model = mjcf.load_model(TWIN_XML, rescale=(0.9, 0.9),
                            torque_actuators=True, device=device)
    if stac_path:
        qpos = load_stac_qpos(stac_path)
    else:
        # demo: the committed twin clip's qpos as a 'recording'
        clip = load_clip(compat.TWIN_CLIP, device="cpu")
        qpos = torch.cat([clip.position, clip.quaternion, clip.joints],
                         1).numpy()

    lib = process_recording(model, qpos, clip_length=125)
    print(f"{lib.num_clips} clips x {lib.clip_length} frames")
    for i in range(lib.num_clips):
        clip = lib.get(i)
        speed = torch.linalg.norm(clip.velocity, dim=-1).mean()
        z = clip.position[:, 2]
        print(f"clip_{i}: mean speed {float(speed):.4f} m/s, root z range "
              f"[{float(z.min()):.3f}, {float(z.max()):.3f}]")
    path = save_features_h5(out, lib)
    print("saved:", path)
    return lib, path


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("stac_path", nargs="?")
    p.add_argument("out", nargs="?",
                   default=os.path.join(tempfile.gettempdir(), "clips.h5"))
    p.add_argument("--device", default="cuda")
    a = p.parse_args(sys.argv[1:])
    main(a.stac_path, a.out, a.device)
