"""Rat walker morphology metadata (PyTorch counterpart of
vnl_tpu/envs/walker.py): the rodent's canonical mocap joint order,
tracked-body sets and feature groups, derived from a compiled Model, so
env configs can be generated from it and feature index maps stay
consistent with the physics model."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

import numpy as np

from vnl_tpu_torch.physics.model import Model

# canonical mocap joint order (reference walker.py:19-87)
RAT_MOCAP_JOINTS: Tuple[str, ...] = (
    "vertebra_1_extend", "vertebra_2_bend", "vertebra_3_twist",
    "vertebra_4_extend", "vertebra_5_bend", "vertebra_6_twist",
    "hip_L_supinate", "hip_L_abduct", "hip_L_extend", "knee_L", "ankle_L",
    "toe_L", "hip_R_supinate", "hip_R_abduct", "hip_R_extend", "knee_R",
    "ankle_R", "toe_R", "vertebra_C1_extend", "vertebra_C1_bend",
    "vertebra_C2_extend", "vertebra_C2_bend", "vertebra_C3_extend",
    "vertebra_C3_bend", "vertebra_C4_extend", "vertebra_C4_bend",
    "vertebra_C5_extend", "vertebra_C5_bend", "vertebra_C6_extend",
    "vertebra_C6_bend", "vertebra_C7_extend", "vertebra_C9_bend",
    "vertebra_C11_extend", "vertebra_C13_bend", "vertebra_C15_extend",
    "vertebra_C17_bend", "vertebra_C19_extend", "vertebra_C21_bend",
    "vertebra_C23_extend", "vertebra_C25_bend", "vertebra_C27_extend",
    "vertebra_C29_bend", "vertebra_cervical_5_extend",
    "vertebra_cervical_4_bend", "vertebra_cervical_3_twist",
    "vertebra_cervical_2_extend", "vertebra_cervical_1_bend",
    "vertebra_axis_twist", "vertebra_atlant_extend", "atlas", "mandible",
    "scapula_L_supinate", "scapula_L_abduct", "scapula_L_extend",
    "shoulder_L", "shoulder_sup_L", "elbow_L", "wrist_L", "finger_L",
    "scapula_R_supinate", "scapula_R_abduct", "scapula_R_extend",
    "shoulder_R", "shoulder_sup_R", "elbow_R", "wrist_R", "finger_R",
)

END_EFFECTOR_BODIES: Tuple[str, ...] = (
    "lower_arm_R", "lower_arm_L", "foot_R", "foot_L")  # walker.py:183-190

_MOCAP_EXCLUDE = re.compile(r"(vertebra|hand|toe)")  # walker.py:221-227


@dataclasses.dataclass(frozen=True)
class RatWalker:
    """Morphology metadata bound to a compiled rodent Model."""

    model: Model

    @property
    def mocap_joint_order(self) -> Tuple[str, ...]:
        present = set(self.model.joint_names)
        return tuple(j for j in RAT_MOCAP_JOINTS if j in present)

    @property
    def mocap_tracking_bodies(self) -> Tuple[str, ...]:
        """Bodies tracked against mocap (defines the clip body axis)."""
        return tuple(b for b in self.model.body_names[1:]
                     if not _MOCAP_EXCLUDE.match(b))

    @property
    def observable_joints(self) -> Tuple[str, ...]:
        """Joints with actuators (walker.py:193-199)."""
        return tuple(self.model.joint_names[j]
                     for j in np.asarray(self.model.actuator_trnid))

    @property
    def end_effectors(self) -> Tuple[str, ...]:
        present = set(self.model.body_names)
        return tuple(b for b in END_EFFECTOR_BODIES if b in present)

    def hinge_index(self, joint_names) -> np.ndarray:
        """Hinge-order indices (qposadr - 7) for named joints: the index
        space the tracking envs use."""
        jmap = {n: i for i, n in enumerate(self.model.joint_names)}
        return np.array([
            int(self.model.jnt_qposadr[jmap[n]]) - 7 for n in joint_names])

    def body_index(self, body_names) -> np.ndarray:
        bmap = {n: i for i, n in enumerate(self.model.body_names)}
        return np.array([bmap[n] for n in body_names])

    @property
    def joint_actuator_order(self) -> np.ndarray:
        """Mocap-order index of each joint actuator's joint
        (reference walker.py:315-325)."""
        trnid = np.asarray(self.model.actuator_trnid).reshape(-1)
        mocap = list(self.mocap_joint_order)
        return np.array([mocap.index(self.model.joint_names[int(j)])
                         for j in trnid])

    def pose_to_actuation(self, pose):
        """Maps a mocap-order pose to the zero-torque actuation point:
        u = (2 q_ref - (lo + hi)) / (hi - lo) per actuated joint
        (reference walker.py:295-312)."""
        trnid = np.asarray(self.model.actuator_trnid).reshape(-1)
        rng = self.model.jnt_range.detach().cpu().numpy()[trnid]
        order = self.joint_actuator_order
        return ((2.0 * pose[..., order] - (rng[:, 0] + rng[:, 1]))
                / (rng[:, 1] - rng[:, 0]))

    def egocentric_camera(self, width: int = 64, height: int = 64):
        """The 64x64 egocentric head camera (reference walker.py:388-405
        observable): camera(d: Data) -> (B, height, width, 3) float32 for
        every env of a batched Data.  The host-side video counterpart is
        render.render_egocentric."""
        from vnl_tpu_torch.render import make_egocentric_camera
        return make_egocentric_camera(self.model, "skull",
                                      width=width, height=height)

    def env_config(self) -> Dict:
        """The tracking env's name lists (env_config.yaml content)."""
        tracked = list(self.mocap_tracking_bodies)
        return dict(
            walker_body_names=tracked,
            end_eff_names=["foot_L", "foot_R", "hand_L", "hand_R"],
            appendage_names=["foot_L", "foot_R", "hand_L", "hand_R", "skull"],
            center_of_mass="torso",
        )
