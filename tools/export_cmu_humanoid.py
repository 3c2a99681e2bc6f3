"""Writes vnl_tpu_torch/assets/dm_cmu_humanoid/cmu_humanoid.xml: dm_control's
CMU humanoid (``CMUHumanoidPositionControlledV2020``, the body that CoMic
and MoCapAct track) on dm_control's locomotion floor, as one MJCF file.

The walker is attached to ``floors.Floor()`` by a free joint and exported
through ``mjcf.export_with_assets``.  The exported file is dm_control's
scene with exactly these changes, which the file's header comment repeats:

- the attachment frame sits at the walker's upright pose
  (``_UPRIGHT_POS_V2020``, ``_UPRIGHT_QUAT`` normalised), so that qpos0
  stands upright;
- ``timestep`` 0.005, the physics step of dm_control's mocap tracking
  task (``locomotion/tasks/reference_pose/tracking.py``);
- the solver of the VNL humanoid env group: CG with 6 iterations and 6
  line-search rounds, the pyramidal cone and no noslip (the arena sets the
  elliptic cone and 5 noslip iterations).

It imports dm_control on the CPU and nothing of vnl_tpu or vnl_tpu_torch.
The output is deterministic.  Run from the repo root:

  python tools/export_cmu_humanoid.py [OUT.xml]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "vnl_tpu_torch", "assets", "dm_cmu_humanoid",
                   "cmu_humanoid.xml")

HEADER = """<!--
  dm_control 1.0.43 (Apache License 2.0, Copyright The dm_control Authors):
  locomotion.walkers.cmu_humanoid.CMUHumanoidPositionControlledV2020 on
  locomotion.arenas.floors.Floor, exported by tools/export_cmu_humanoid.py
  through mjcf.export_with_assets.  Changed from dm_control's scene:
  - the free attachment frame at the upright pose (_UPRIGHT_POS_V2020,
    _UPRIGHT_QUAT normalised), so that qpos0 stands upright;
  - option timestep 0.005, the physics step of dm_control's mocap tracking
    task (locomotion/tasks/reference_pose/tracking.py);
  - option solver CG, iterations 6, ls_iterations 6, cone pyramidal,
    noslip_iterations 0: the VNL humanoid env group's solver (the arena
    sets the elliptic cone and 5 noslip iterations).
-->
"""


def scene_xml() -> str:
    """The scene as one MJCF string, header comment first."""
    from dm_control import mjcf
    from dm_control.locomotion.arenas import floors
    from dm_control.locomotion.walkers import cmu_humanoid

    walker = cmu_humanoid.CMUHumanoidPositionControlledV2020()
    arena = floors.Floor()
    frame = arena.add_free_entity(walker)
    frame.pos = cmu_humanoid._UPRIGHT_POS_V2020
    quat = np.asarray(cmu_humanoid._UPRIGHT_QUAT, np.float64)
    frame.quat = quat / np.linalg.norm(quat)
    opt = arena.mjcf_model.option
    opt.timestep = 0.005
    opt.solver = "CG"
    opt.iterations = 6
    opt.ls_iterations = 6
    opt.cone = "pyramidal"
    opt.noslip_iterations = 0
    with tempfile.TemporaryDirectory() as tmp:
        mjcf.export_with_assets(arena.mjcf_model, tmp, "scene.xml")
        extra = sorted(set(os.listdir(tmp)) - {"scene.xml"})
        if extra:
            raise RuntimeError(f"the scene references asset files: {extra}")
        with open(os.path.join(tmp, "scene.xml")) as f:
            return HEADER + f.read()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else OUT
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write(scene_xml())
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
