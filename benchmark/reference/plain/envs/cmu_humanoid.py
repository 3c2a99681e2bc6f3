"""The CMU humanoid tracking env of the configuration
``cmu_humanoid_tracking``: the reference's ``HumanoidTracking``
(``envs/humanoid.py``) on dm_control's CMU humanoid V2020.

The walker is the committed scene ``vnl_tpu_torch/assets/dm_cmu_humanoid/
cmu_humanoid.xml`` compiled with CG, 6 iterations and 6 line-search rounds
(``../assets/cmu_humanoid_model.npz``, tools/export_torch_assets.py
``--benchmark-cmu``).  Its sphere-, capsule- and ellipsoid-ellipsoid pairs
take the narrowphase of ``physics/convex.py``, which this module registers
when it is imported."""

from __future__ import annotations

import os

import torch

from benchmark.reference.plain import compat
from benchmark.reference.plain.envs.humanoid import HumanoidTracking
from benchmark.reference.plain.physics import convex

convex.register()

CMU_MODEL = os.path.join(compat.ASSETS, "cmu_humanoid_model.npz")


def make_cmu_humanoid_env(device="cuda", dtype=torch.float32, mjcf_path=None,
                          **overrides) -> HumanoidTracking:
    """HumanoidTracking on the compiled CMU humanoid and its static clip,
    with the env's defaults; ``dtype``: of the model's floating tables and
    of the clip.  ``mjcf_path``, the scene the program compiles, is taken
    and left: the model file is its compile."""
    model = compat.model_from_numpy(CMU_MODEL, device=device, dtype=dtype)
    return HumanoidTracking(model, dtype=dtype, **overrides)
