"""Physics model and state containers (PyTorch counterpart of
vnl_tpu/physics/model.py).

``Model`` is a dataclass whose array leaves are torch tensors on one device
and whose index tables, sizes and names stay numpy / Python (they only ever
index).  ``Data`` holds the dynamic state of a whole batch: every field
carries the batch as its leading dimension (the JAX package vmaps a per-env
``Data`` instead).  Enum codes match MuJoCo's, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch


class JointType(enum.IntEnum):
    FREE = 0
    BALL = 1
    SLIDE = 2
    HINGE = 3


class GeomType(enum.IntEnum):
    PLANE = 0
    HFIELD = 1
    SPHERE = 2
    CAPSULE = 3
    ELLIPSOID = 4
    CYLINDER = 5
    BOX = 6
    MESH = 7


class DynType(enum.IntEnum):
    NONE = 0
    INTEGRATOR = 1
    FILTER = 2
    FILTEREXACT = 3


class GainType(enum.IntEnum):
    FIXED = 0
    AFFINE = 1


class BiasType(enum.IntEnum):
    NONE = 0
    AFFINE = 1


class ConeType(enum.IntEnum):
    PYRAMIDAL = 0
    ELLIPTIC = 1


class SolverType(enum.IntEnum):
    PGS = 0
    CG = 1
    NEWTON = 2


class IntegratorType(enum.IntEnum):
    EULER = 0
    RK4 = 1
    IMPLICIT = 2
    IMPLICITFAST = 3


class DisableBit(enum.IntFlag):
    CONSTRAINT = 1 << 0
    EQUALITY = 1 << 1
    FRICTIONLOSS = 1 << 2
    LIMIT = 1 << 3
    CONTACT = 1 << 4
    PASSIVE = 1 << 5
    GRAVITY = 1 << 6
    CLAMPCTRL = 1 << 7
    ACTUATION = 1 << 10
    EULERDAMP = 1 << 16


@dataclasses.dataclass(frozen=True)
class Option:
    """Simulation options (mjOption analogue)."""

    timestep: float = 0.002
    impratio: float = 1.0
    tolerance: float = 1e-8
    ls_tolerance: float = 0.01
    integrator: int = int(IntegratorType.EULER)
    cone: int = int(ConeType.PYRAMIDAL)
    solver: int = int(SolverType.NEWTON)
    iterations: int = 100
    ls_iterations: int = 50
    disableflags: int = 0
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    wind: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    density: float = 0.0
    viscosity: float = 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    """Compiled model: sizes, Option, numpy index tables, names, and the
    float/bool/int leaves as tensors on ``device``.  Field names follow
    the JAX package (and MuJoCo)."""

    nq: int
    nv: int
    nu: int
    na: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    npair: int
    ncon_max: int
    nlimit: int
    nkey: int
    nsensor: int
    nsensordata: int
    opt: Option
    # numpy index tables
    jnt_type: np.ndarray
    jnt_qposadr: np.ndarray
    jnt_dofadr: np.ndarray
    jnt_bodyid: np.ndarray
    jnt_limited: np.ndarray
    dof_bodyid: np.ndarray
    dof_jntid: np.ndarray
    body_parentid: np.ndarray
    body_rootid: np.ndarray
    body_jntadr: np.ndarray
    body_jntnum: np.ndarray
    body_dofadr: np.ndarray
    body_dofnum: np.ndarray
    body_treeid: np.ndarray
    geom_bodyid: np.ndarray
    geom_type: np.ndarray
    site_bodyid: np.ndarray
    site_type: np.ndarray
    sensor_type: np.ndarray
    sensor_objid: np.ndarray
    sensor_adr: np.ndarray
    sensor_dim: np.ndarray
    actuator_trnid: np.ndarray
    actuator_dyntype: np.ndarray
    actuator_gaintype: np.ndarray
    actuator_biastype: np.ndarray
    pair_geom1: np.ndarray
    pair_geom2: np.ndarray
    pair_dim: np.ndarray
    dof_ancestor_mask: np.ndarray     # (nv, nv) dof j ancestor-or-self of i
    body_subtree_mask: np.ndarray     # (nbody, nbody) c in subtree(b)
    body_chain_dof_mask: np.ndarray   # (nbody, nv) dof in chain of b
    dof_prefix_mask: np.ndarray       # (nv, nv)
    # names
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]
    geom_names: Tuple[str, ...]
    site_names: Tuple[str, ...]
    actuator_names: Tuple[str, ...]
    sensor_names: Tuple[str, ...]
    key_names: Tuple[str, ...]
    # device tensors
    qpos0: torch.Tensor
    qpos_spring: torch.Tensor
    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_ipos: torch.Tensor
    body_iquat: torch.Tensor
    body_mass: torch.Tensor
    body_inertia: torch.Tensor
    body_subtreemass: torch.Tensor
    jnt_pos: torch.Tensor
    jnt_axis: torch.Tensor
    jnt_range: torch.Tensor
    jnt_stiffness: torch.Tensor
    jnt_margin: torch.Tensor
    jnt_solref: torch.Tensor
    jnt_solimp: torch.Tensor
    dof_armature: torch.Tensor
    dof_damping: torch.Tensor
    dof_frictionloss: torch.Tensor
    dof_invweight0: torch.Tensor
    body_invweight0: torch.Tensor
    geom_pos: torch.Tensor
    geom_quat: torch.Tensor
    geom_size: torch.Tensor
    geom_friction: torch.Tensor
    geom_solref: torch.Tensor
    geom_solimp: torch.Tensor
    geom_margin: torch.Tensor
    geom_gap: torch.Tensor
    geom_rbound: torch.Tensor
    site_pos: torch.Tensor
    site_quat: torch.Tensor
    site_size: torch.Tensor
    actuator_gear: torch.Tensor
    actuator_gainprm: torch.Tensor
    actuator_biasprm: torch.Tensor
    actuator_dynprm: torch.Tensor
    actuator_ctrlrange: torch.Tensor
    actuator_forcerange: torch.Tensor
    actuator_ctrllimited: torch.Tensor
    actuator_forcelimited: torch.Tensor
    actuator_actadr: torch.Tensor
    pair_friction: torch.Tensor
    pair_solref: torch.Tensor
    pair_solimp: torch.Tensor
    pair_margin: torch.Tensor
    pair_gap: torch.Tensor
    key_qpos: torch.Tensor
    # device copies of the numpy tables, made once (see ``table``)
    cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    def table(self, name: str, dtype=torch.float32) -> torch.Tensor:
        """A numpy index table as a tensor on the model's device, copied
        once per (name, dtype)."""
        key = ("table", name, dtype)
        if key not in self.cache:
            self.cache[key] = torch.as_tensor(
                np.asarray(getattr(self, name)), device=self.device,
                dtype=dtype)
        return self.cache[key]

    def const(self, arr, dtype) -> torch.Tensor:
        """A static numpy array as a tensor on the device, copied once."""
        arr = np.asarray(arr)
        key = ("const", arr.tobytes(), arr.shape, arr.dtype.str, dtype)
        if key not in self.cache:
            self.cache[key] = torch.as_tensor(arr, device=self.device,
                                              dtype=dtype)
        return self.cache[key]

    def index(self, idx) -> torch.Tensor:
        """A static numpy index array as a long tensor on the device."""
        return self.const(np.asarray(idx, dtype=np.int64), torch.long)


@dataclasses.dataclass(frozen=True, eq=False)
class Data:
    """Dynamic state of B envs; every tensor is (B, ...)."""

    qpos: torch.Tensor             # (B, nq)
    qvel: torch.Tensor             # (B, nv)
    act: torch.Tensor              # (B, na)
    ctrl: torch.Tensor             # (B, nu)
    xpos: torch.Tensor             # (B, nbody, 3)
    xquat: torch.Tensor            # (B, nbody, 4)
    xmat: torch.Tensor             # (B, nbody, 3, 3)
    xipos: torch.Tensor            # (B, nbody, 3)
    xanchor: torch.Tensor          # (B, njnt, 3)
    xaxis: torch.Tensor            # (B, njnt, 3)
    geom_xpos: torch.Tensor        # (B, ngeom, 3)
    geom_xmat: torch.Tensor        # (B, ngeom, 3, 3)
    subtree_com: torch.Tensor      # (B, nbody, 3)
    cinert: torch.Tensor           # (B, nbody, 6, 6)
    cdof: torch.Tensor             # (B, nv, 6)
    cvel: torch.Tensor             # (B, nbody, 6)
    qM: torch.Tensor               # (B, nv, nv)
    qMinv: torch.Tensor            # (B, nv, nv)
    qMhBinv: torch.Tensor          # (B, nv, nv) (M + h diag(damping))^-1
    qfrc_bias: torch.Tensor        # (B, nv)
    qfrc_passive: torch.Tensor     # (B, nv)
    qfrc_actuator: torch.Tensor    # (B, nv)
    actuator_force: torch.Tensor   # (B, nu)
    act_dot: torch.Tensor          # (B, na)
    qfrc_smooth: torch.Tensor      # (B, nv)
    qacc_smooth: torch.Tensor      # (B, nv)
    qfrc_constraint: torch.Tensor  # (B, nv)
    qacc: torch.Tensor             # (B, nv)
    contact_dist: torch.Tensor     # (B, ncon_max)
    contact_pos: torch.Tensor      # (B, ncon_max, 3)
    contact_frame: torch.Tensor    # (B, ncon_max, 3, 3)
    contact_force: torch.Tensor    # (B, ncon_max, 4)

    def replace(self, **kwargs) -> "Data":
        return dataclasses.replace(self, **kwargs)


