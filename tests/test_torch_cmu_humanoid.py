"""dm_control's CMU humanoid V2020 (configuration ``cmu_humanoid_tracking``)
on the CPU, and kernels E and B at its shapes on the card:

(a) the three convex pair types the port adds (sphere, capsule and
ellipsoid against an ellipsoid; physics/collision.py) against MuJoCo's
convex collider on seeded relative poses, penetrating and within margin;
(b) the same poses, the port's plain routines against the benchmark's
frozen copy (benchmark/reference/plain/physics/convex.py), bit for bit in
float32 and float64;
(c) the committed scene the export tool's output; the port's compile of it
against ``mujoco.MjModel``, and the reference's model file that compile,
bit for bit;
(d) the port's HumanoidTracking on the scene against the reference env
(benchmark/reference/plain/envs/cmu_humanoid.py), 2 envs, 2 control steps;
(e) the reference's other envs leave its pair types at the JAX package's
ten, in a process of their own;
(f) kernel E's tables and the pair groups a capture notes;
(g) the convex pairs find the least of the support function where the
cores overlap, on poses deep in the ellipsoid, against a grid of
directions;
(h) marked ``cuda``: kernel E's convex instantiation (on the CMU humanoid
and on the deep poses) and kernel B's widest route at the CMU system
against their plain versions, the latter with two planted faults."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import judge, spec
from benchmark.reference.plain.physics import collision as ref_collision
from tools import export_torch_assets as exporter
from vnl_tpu_torch import compat, kernel_bench
from vnl_tpu_torch import mjcf as tmjcf
from vnl_tpu_torch.envs import HumanoidTracking, wrap_for_training
from vnl_tpu_torch.ops import cg as cg_ops
from vnl_tpu_torch.ops import collision as col_ops
from vnl_tpu_torch.ops import launch_counts
from vnl_tpu_torch.physics import collision, forward, kinematics
from vnl_tpu_torch.physics.model import GeomType as G

CONFIG = os.path.join(spec.ROOT, "benchmark", "configs",
                      "cmu_humanoid_tracking.json")
KINDS = ("sphere", "capsule", "ellipsoid")      # geom 1; geom 2 an ellipsoid
NSIZE = dict(sphere=1, capsule=2, ellipsoid=3)
POSES = 16
MARGIN = 0.02

PAIR_XML = """<mujoco><option><flag gravity="disable"/></option><worldbody>
<body><freejoint/><geom type="{t1}" size="{s1}" margin="{mg}"/></body>
<body><freejoint/><geom type="ellipsoid" size="{s2}" margin="{mg}"/></body>
</worldbody></mujoco>"""


@pytest.fixture(scope="module")
def cfg():
    with open(CONFIG) as f:
        return json.load(f)


def _rotation(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def _mujoco_poses(kind: str, seed: int):
    """POSES poses of a ``kind`` geom against an ellipsoid, sizes near the
    CMU humanoid's (the hands are 0.042 x 0.024 x 0.054), each placed
    along a random direction at a drawn signed distance in [-0.02, 0.015]
    (bisection on MuJoCo's own distance; the signed distance of two
    centred symmetric shapes grows along a ray).  Returns per pose: both
    geoms' sizes (3,), positions (2, 3), rotations (2, 3, 3) and MuJoCo's
    contact (dist, pos, normal)."""
    mujoco = pytest.importorskip("mujoco")
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < POSES:
        s1 = np.zeros(3)
        s1[0] = rng.uniform(0.015, 0.05)
        if kind == "capsule":
            s1[1] = rng.uniform(0.03, 0.12)
        if kind == "ellipsoid":
            s1 = rng.uniform(0.02, 0.06, 3)
        s2 = rng.uniform(0.02, 0.06, 3)
        m = mujoco.MjModel.from_xml_string(PAIR_XML.format(
            t1=kind, s1=" ".join(map(str, s1[:NSIZE[kind]])),
            s2=" ".join(map(str, s2)), mg=MARGIN))
        d = mujoco.MjData(m)
        q1, q2 = _rotation(rng), _rotation(rng)
        ray = rng.normal(size=3)
        ray /= np.linalg.norm(ray)
        target = rng.uniform(-0.02, 0.015)

        def place(r):
            d.qpos[:] = np.r_[0, 0, 0, q1, r * ray, q2]
            mujoco.mj_forward(m, d)
            return d.contact[0].dist if d.ncon else np.inf

        lo, hi = 0.0, 0.4
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if place(mid) <= target else (lo, mid)
        if not place(lo) < MARGIN or d.ncon != 1:
            continue
        c = d.contact[0]
        assert (c.geom1, c.geom2) == (0, 1)
        out.append(dict(s=np.stack([s1, s2]), x=d.geom_xpos.copy(),
                        R=d.geom_xmat.reshape(2, 3, 3).copy(), dist=c.dist,
                        pos=c.pos.copy(), normal=c.frame[:3].copy()))
    return out


def _batch(poses, dtype):
    """The poses as the narrowphase's arguments: (x1, R1, s1, x2, R2, s2)
    with a batch of one env and the poses as its pairs."""
    x = torch.tensor(np.stack([p["x"] for p in poses]), dtype=dtype)
    R = torch.tensor(np.stack([p["R"] for p in poses]), dtype=dtype)
    s = torch.tensor(np.stack([p["s"] for p in poses]), dtype=dtype)
    return x[None, :, 0], R[None, :, 0], s[:, 0], x[None, :, 1], \
        R[None, :, 1], s[:, 1]


def _separation(kind, p, n):
    """The gap of the pair along unit normal ``n`` (geom 1 to geom 2),
    from the shapes' support functions in float64: min over geom 2 of n.b
    less max over geom 1 of n.a.  The signed distance is its greatest
    over n (the separating axis theorem, overlap included)."""
    (x1, x2), (R1, R2), (s1, s2) = p["x"], p["R"], p["s"]
    far2 = n @ x2 - np.linalg.norm(s2 * (R2.T @ n))
    if kind == "ellipsoid":
        near1 = n @ x1 + np.linalg.norm(s1 * (R1.T @ n))
    else:
        near1 = n @ x1 + s1[0] + s1[1] * abs(n @ R1[:, 2])
    return far2 - near1


@pytest.mark.parametrize("kind", KINDS)
def test_convex_pairs_against_mujoco(kind):
    """MuJoCo 3.10's convex collider (GJK, then EPA where the cores
    overlap) at the scene's ccd_tolerance 1e-6 and 35 iterations, against
    the port's float64 routine, which runs its Newton steps to the
    rounding of float64.  MuJoCo brackets the signed distance: its GJK
    and EPA report a distance at or above the true one (the simplex or
    polytope lies inside the shapes' Minkowski difference), and the gap
    along its normal (_separation) is at or below it (the true distance
    is the greatest gap over all normals).  So:
    - the port's distance lies in that bracket, within 1e-9 (float64),
      and equals the gap along its own normal within 1e-9: the bracket
      is 0 to 3.2e-5 wide on these poses, widest where EPA runs;
    - normal within 0.05 and point within 5e-4: EPA reports the normal
      of its polytope's face nearest the origin, off the surface's by up
      to the face's angular size (0.024 on these poses), and the point
      moves with the normal by the surface's radius of curvature (1.4e-4
      on these poses)."""
    poses = _mujoco_poses(kind, seed=25 + KINDS.index(kind))
    fn = collision._NARROWPHASE[(G[kind.upper()], G.ELLIPSOID)]
    (dist, pos, frame), = fn(*_batch(poses, torch.float64))
    for i, p in enumerate(poses):
        n, got = frame[0, i, 0].numpy(), float(dist[0, i])
        assert _separation(kind, p, p["normal"]) - 1e-9 <= got, i
        assert got <= p["dist"] + 1e-9, i
        assert abs(_separation(kind, p, n) - got) <= 1e-9, i
        assert np.abs(n - p["normal"]).max() <= 0.05, i
        assert np.abs(pos[0, i].numpy() - p["pos"]).max() <= 5e-4, i
    assert min(p["dist"] for p in poses) < 0.0 < max(p["dist"] for p in poses)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_convex_pairs_are_the_references(dtype):
    """The port's plain routines and the reference's frozen copy give the
    same bits on the same poses, in either precision."""
    from benchmark.reference.plain.physics import convex
    convex.register()
    for kind in KINDS:
        args = _batch(_mujoco_poses(kind, seed=25 + KINDS.index(kind)), dtype)
        key = (G[kind.upper()], G.ELLIPSOID)
        got, = collision._NARROWPHASE[key](*args)
        want, = ref_collision._NARROWPHASE[key](*args)
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w), kind


DEEP_POSES = 512


def _deep_args(kind, dtype=torch.float64):
    """kernel_bench.deep_convex_poses as the narrowphase's arguments
    (one env, the poses its pairs) and the grid's greatest gaps."""
    (x, R), grid = kernel_bench.deep_convex_poses(
        kind, DEEP_POSES, seed=31 + KINDS.index(kind))
    s1 = torch.tensor(kernel_bench.DEEP_SIZES[kind], dtype=dtype)
    s2 = torch.tensor(kernel_bench.HAND, dtype=dtype)
    x, R = x.to(dtype), R.to(dtype)
    return (x[None, :, 0], R[None, :, 0], s1.expand(DEEP_POSES, 3),
            x[None, :, 1], R[None, :, 1], s2.expand(DEEP_POSES, 3)), grid


@pytest.mark.parametrize("kind", KINDS)
def test_convex_pairs_find_the_least_where_cores_overlap(kind):
    """Deep in the ellipsoid H has several local leasts, and a search from
    one start may end in the wrong one (the routine of one search from
    the best start missed on 1 capsule and 2 ellipsoid poses of these,
    by up to 3.0e-3 m).  The port's float64 distance is at or above the
    greatest gap along a grid of directions, within float64 rounding; the
    reference's copy gives the same bits in float32 and float64."""
    from benchmark.reference.plain.physics import convex
    convex.register()
    args, grid = _deep_args(kind)
    key = (G[kind.upper()], G.ELLIPSOID)
    (dist, _, _), = collision._NARROWPHASE[key](*args)
    assert float((grid - dist[0]).max()) <= 1e-9
    for dtype in (torch.float32, torch.float64):
        a = _deep_args(kind, dtype)[0] if dtype == torch.float32 else args
        got, = collision._NARROWPHASE[key](*a)
        want, = ref_collision._NARROWPHASE[key](*a)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (kind, dtype)


def test_compile_against_mujoco():
    """The port's compile of the committed scene (the envs' and the
    reference's) against MuJoCo's, within float32 rounding of each
    table's largest entry: masses, inertia tensors (in the body frame, so
    that the principal axes' order and signs do not matter), body frames,
    joint ranges, springs, armature, damping, actuator gain, bias and
    dynamics, and geom sizes.  Centres of mass only where a body has mass
    of its own: a body without (the attachment frame, the face) carries
    the compiler's boundmass, 1e-5 kg, whose placement MuJoCo does not
    define the port's way."""
    mujoco = pytest.importorskip("mujoco")
    got = tmjcf.compile_numpy(tmjcf.load_spec(compat.CMU_HUMANOID_XML,
                                              **exporter.HUMANOID_COMPILE))
    mj = mujoco.MjModel.from_xml_path(compat.CMU_HUMANOID_XML)
    assert [int(got[k]) for k in ("nq", "nv", "nu", "na", "nbody", "ngeom")] \
        == [63, 62, 56, 56, 34, 48]
    assert list(got["geom_names"]) == [mj.geom(i).name
                                       for i in range(mj.ngeom)]

    def rot(q):
        out = np.zeros(9)
        mujoco.mju_quat2Mat(out, np.asarray(q, np.float64))
        return out.reshape(3, 3)

    def tensor(quats, diags):
        return np.stack([rot(q) @ np.diag(d) @ rot(q).T
                         for q, d in zip(quats, diags)])

    massive = mj.body_mass > 1e-4
    pairs = {
        "body_mass": (got["body_mass"], mj.body_mass),
        "inertia": (tensor(got["body_iquat"], got["body_inertia"]),
                    tensor(mj.body_iquat, mj.body_inertia)),
        "body_pos": (got["body_pos"], mj.body_pos),
        "body_quat": (got["body_quat"], mj.body_quat),
        "body_ipos": (got["body_ipos"][massive], mj.body_ipos[massive]),
        "jnt_range": (got["jnt_range"], mj.jnt_range),
        "jnt_stiffness": (got["jnt_stiffness"], mj.jnt_stiffness),
        "qpos_spring": (got["qpos_spring"], mj.qpos_spring),
        "dof_armature": (got["dof_armature"], mj.dof_armature),
        "dof_damping": (got["dof_damping"], mj.dof_damping),
        "actuator_gainprm": (got["actuator_gainprm"],
                             mj.actuator_gainprm[:, :3]),
        "actuator_biasprm": (got["actuator_biasprm"],
                             mj.actuator_biasprm[:, :3]),
        "actuator_dynprm": (got["actuator_dynprm"], mj.actuator_dynprm[:, :1]),
        "geom_size": (got["geom_size"], mj.geom_size)}
    for name, (a, b) in pairs.items():
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, err_msg=name,
                                   atol=4e-7 * max(np.abs(b).max(), 1e-6))
    for name in ("actuator_dyntype", "actuator_gaintype", "actuator_biastype",
                 "geom_type"):
        np.testing.assert_array_equal(got[name], getattr(mj, name), name)


def test_scene_is_the_tools_export():
    """The committed scene is tools/export_cmu_humanoid.py's output, byte
    for byte (dm_control on the CPU)."""
    pytest.importorskip("dm_control")
    from tools import export_cmu_humanoid
    with open(compat.CMU_HUMANOID_XML) as f:
        assert export_cmu_humanoid.scene_xml() == f.read()


def test_reference_model_is_the_ports_compile():
    """benchmark/reference/assets/cmu_humanoid_model.npz is
    tools/export_torch_assets.py --benchmark-cmu's output, bit for bit."""
    from benchmark.reference.plain.envs.cmu_humanoid import CMU_MODEL
    got = exporter.cmu_model_numpy()
    with np.load(CMU_MODEL) as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


# contact points a candidate pair of each type emits (MuJoCo's convex
# collider without multiccd, and its plane-capsule's two)
NCON_OF_TYPES = {(G.PLANE, G.CAPSULE): 2}


def _mujoco_pairs(mj):
    """MuJoCo's own candidate pairs of ``mj`` and their contact
    parameters: every geom pair its filters (contype / conaffinity,
    parent and weld exclusions) let through, found as the contacts of
    qpos0 with every geom's margin widened to 10 m before the compile
    (the broadphase reads the bodies' margins it derives).  Returns
    {(geom 1, geom 2): (dim, friction (5,), solref (2,), solimp (5,))}."""
    mujoco = pytest.importorskip("mujoco")
    spec = mujoco.MjSpec.from_file(compat.CMU_HUMANOID_XML)
    for g in spec.geoms:
        g.margin = 10.0
    wide = spec.compile()
    d = mujoco.MjData(wide)
    mujoco.mj_forward(wide, d)
    out = {}
    for c in d.contact[:d.ncon]:
        out[(int(c.geom1), int(c.geom2))] = (
            int(c.dim), np.array(c.friction), np.array(c.solref),
            np.array(c.solimp))
    return out


def test_reference_model_against_mujoco():
    """Every table of the reference's model file
    (benchmark/reference/assets/cmu_humanoid_model.npz, the port's
    compile) against MuJoCo 3.10's compile of the committed scene, within
    float32 rounding of each table's largest entry, so that the judge
    does not share a fault of the port's compiler: sizes, options,
    indices, names, bodies (inertia as the tensor in the body frame;
    centres of mass where a body has mass of its own, as
    test_compile_against_mujoco says), joints, dofs, geoms, sites,
    the sensors the port compiles, and actuators; the tree masks from MuJoCo's parents; and the
    945 candidate pairs with their condim, friction, solref and solimp
    against the contacts of MuJoCo's own filters (_mujoco_pairs), their
    margin and gap the larger of the two geoms'.  Each table is checked
    once, and none is left out."""
    mujoco = pytest.importorskip("mujoco")
    from benchmark.reference.plain.envs.cmu_humanoid import CMU_MODEL
    with np.load(CMU_MODEL) as f:
        z = {k: f[k] for k in f.files}
    mj = mujoco.MjModel.from_xml_path(compat.CMU_HUMANOID_XML)
    done, bad = set(), []

    def close(key, want, got=None):
        got = np.asarray(z[key] if got is None else got, np.float64)
        want = np.asarray(want, np.float64)
        tol = 4e-7 * max(np.abs(want).max(initial=0.0), 1e-6)
        if got.shape != want.shape or not np.all(np.abs(got - want) <= tol):
            bad.append(key)
        done.add(key)

    def equal(key, want):
        if not np.array_equal(np.asarray(z[key]), np.asarray(want)):
            bad.append(key)
        done.add(key)

    for k in ("nq", "nv", "nu", "na", "nbody", "njnt", "ngeom", "nsite",
              "nkey"):
        equal(k, getattr(mj, k))
    # the sensors the port compiles: MuJoCo's first 13 (velocimeter, gyro,
    # accelerometer, touch); the torque and framepos sensors after them
    # it leaves out, and no env step evaluates sensors
    ns = int(z["nsensor"])
    assert ns == 13 and set(mj.sensor_type[ns:]) == {5, 26}
    equal("nsensor", ns)
    equal("nsensordata", int(mj.sensor_dim[:ns].sum()))
    for k in ("sensor_type", "sensor_objid", "sensor_adr", "sensor_dim"):
        equal(k, getattr(mj, k)[:ns])
    for k in ("timestep", "impratio", "tolerance", "ls_tolerance",
              "integrator", "cone", "solver", "iterations", "ls_iterations",
              "disableflags", "gravity", "wind", "density", "viscosity"):
        close("opt_" + k, getattr(mj.opt, k))
    for k in ("jnt_type", "jnt_qposadr", "jnt_dofadr", "jnt_bodyid",
              "jnt_limited", "dof_bodyid", "dof_jntid", "body_parentid",
              "body_rootid", "body_jntnum", "body_dofnum", "geom_bodyid", "geom_type", "site_bodyid",
              "site_type", "actuator_dyntype", "actuator_gaintype",
              "actuator_biastype", "actuator_actadr", "actuator_ctrllimited",
              "actuator_forcelimited"):
        equal(k, getattr(mj, k))
    equal("actuator_trnid", mj.actuator_trnid[:, 0])
    # a body without joints or dofs: MuJoCo's address -1, the port's 0
    for k, num in (("body_jntadr", mj.body_jntnum),
                   ("body_dofadr", mj.body_dofnum)):
        equal(k, np.where(num > 0, getattr(mj, k), 0))
    for k, obj, n in (("body_names", mj.body, mj.nbody),
                      ("joint_names", mj.joint, mj.njnt),
                      ("geom_names", mj.geom, mj.ngeom),
                      ("site_names", mj.site, mj.nsite),
                      ("actuator_names", mj.actuator, mj.nu),
                      ("sensor_names", mj.sensor, ns),
                      ("key_names", mj.key, mj.nkey)):
        equal(k, [obj(i).name for i in range(n)])
    for k in ("qpos0", "qpos_spring", "body_pos", "body_quat", "body_mass",
              "body_subtreemass", "jnt_pos", "jnt_axis", "jnt_range",
              "jnt_stiffness", "dof_armature", "dof_damping",
              "dof_frictionloss", "geom_pos", "geom_quat", "geom_size",
              "geom_friction", "geom_solref", "geom_solimp", "geom_margin",
              "geom_gap", "geom_rbound", "site_pos", "site_quat", "site_size",
              "actuator_ctrlrange", "actuator_forcerange", "key_qpos"):
        close(k, getattr(mj, k))
    # a limit's parameters, of the joints with limits (the port leaves
    # the free joint's at 0)
    lim = mj.jnt_limited.astype(bool)
    for k in ("jnt_margin", "jnt_solref", "jnt_solimp"):
        close(k, getattr(mj, k)[lim], z[k][lim])
    # the inverse weights at qpos0, of the dofs and of the bodies that
    # carry a geom (contacts read no other), within 1e-4 relative: the two
    # bodies without mass of their own (the attachment frame, the face)
    # carry boundmass at their origin in the port and elsewhere in MuJoCo,
    # which moves the dofs' by up to 6e-5.  The face's own (its geom the
    # nose) is taken at that centre of mass: 0.325 against MuJoCo's 1.095,
    # a deviation of the port's compile (ROADMAP), held to its value here
    geomed = np.unique(mj.geom_bodyid)
    for k, got, want in (
            ("dof_invweight0", z["dof_invweight0"], mj.dof_invweight0),
            ("body_invweight0", z["body_invweight0"][geomed],
             mj.body_invweight0[geomed, 0])):
        off = ~(np.abs(got - want) <= 1e-4 * np.abs(want))
        if k == "body_invweight0":
            off &= geomed != mj.body("walker/face").id
        if off.any():
            bad.append(k)
        done.add(k)
    face = mj.body("walker/face").id
    assert abs(z["body_invweight0"][face] - 0.32525) < 1e-5
    close("actuator_gear", mj.actuator_gear[:, 0])
    close("actuator_gainprm", mj.actuator_gainprm[:, :3])
    close("actuator_biasprm", mj.actuator_biasprm[:, :3])
    close("actuator_dynprm", mj.actuator_dynprm[:, :1])

    def tensor(quats, diags):
        out = []
        for q, dg in zip(quats, diags):
            r = np.zeros(9)
            mujoco.mju_quat2Mat(r, np.asarray(q, np.float64))
            r = r.reshape(3, 3)
            out.append(r @ np.diag(dg) @ r.T)
        return np.stack(out)
    close("body_inertia", tensor(mj.body_iquat, mj.body_inertia),
          tensor(z["body_iquat"], z["body_inertia"]))
    done.add("body_iquat")
    massive = mj.body_mass > 1e-4
    close("body_ipos", mj.body_ipos[massive], z["body_ipos"][massive])

    # the tree, from MuJoCo's parents
    parent, nb, nv = mj.body_parentid, mj.nbody, mj.nv
    depth = np.zeros(nb, np.int64)
    for b in range(1, nb):
        depth[b] = depth[parent[b]] + 1
    equal("body_treeid", depth)
    equal("nlimit", int(mj.jnt_limited.sum()))
    anc = np.zeros((nv, nv), bool)
    for i in range(nv):
        d = i
        while d >= 0:
            anc[i, d] = True
            d = mj.dof_parentid[d]
    equal("dof_ancestor_mask", anc)
    sub = np.zeros((nb, nb))
    chain = np.zeros((nb, nv))
    for b in range(nb):
        bb = b
        while True:
            sub[bb, b] = 1.0
            if bb == 0:
                break
            if mj.body_dofnum[bb]:
                a0 = mj.body_dofadr[bb]
                chain[b, a0:a0 + mj.body_dofnum[bb]] = 1.0
            bb = parent[bb]
    equal("body_subtree_mask", sub)
    equal("body_chain_dof_mask", chain)
    prefix = np.zeros((nv, nv))
    for j in range(mj.njnt):
        b, adr = mj.jnt_bodyid[j], mj.jnt_dofadr[j]
        base = chain[parent[b]].copy()
        for j2 in range(mj.body_jntadr[b], j):
            a2 = mj.jnt_dofadr[j2]
            base[a2:a2 + (6 if mj.jnt_type[j2] == 0 else 1)] = 1.0
        for k in range(6 if mj.jnt_type[j] == 0 else 1):
            row = base.copy()
            if mj.jnt_type[j] == 0 and k >= 3:
                row[adr:adr + 3] = 1.0
            prefix[adr + k] = row
    equal("dof_prefix_mask", prefix)

    # the candidate pairs
    want = _mujoco_pairs(mj)
    pairs = list(zip(z["pair_geom1"].tolist(), z["pair_geom2"].tolist()))
    assert sorted(tuple(sorted(p)) for p in pairs) == \
        sorted(tuple(sorted(p)) for p in want)
    equal("npair", len(want))
    key = [p if p in want else p[::-1] for p in pairs]
    done.update(("pair_geom1", "pair_geom2"))
    equal("pair_dim", [want[p][0] for p in key])
    for k, i in (("pair_friction", 1), ("pair_solref", 2), ("pair_solimp", 3)):
        close(k, np.stack([want[p][i] for p in key]))
    g1, g2 = z["pair_geom1"], z["pair_geom2"]
    close("pair_margin", np.maximum(mj.geom_margin[g1], mj.geom_margin[g2]))
    close("pair_gap", np.maximum(mj.geom_gap[g1], mj.geom_gap[g2]))
    types = [(G(mj.geom_type[a]), G(mj.geom_type[b])) for a, b in pairs]
    equal("ncon_max", sum(NCON_OF_TYPES.get(t, 1) for t in types))
    assert not bad, bad
    assert sorted(done) == sorted(z), sorted(set(z) - done)


def _gap(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs().amax(-1)
                  / b.abs().amax(-1).clamp(min=1.0)).max())


def test_port_env_matches_the_reference_copy(cfg):
    from benchmark.reference.plain.envs.cmu_humanoid import \
        make_cmu_humanoid_env
    from benchmark.reference.plain.envs.wrappers import \
        wrap_for_training as ref_wrap
    env = wrap_for_training(HumanoidTracking(device="cpu", **cfg["env_args"]),
                            episode_length=cfg["ppo"]["episode_length"])
    ref = ref_wrap(make_cmu_humanoid_env(device="cpu", **cfg["env_args"]),
                   episode_length=cfg["ppo"]["episode_length"])
    state = env.reset(2, generator=torch.Generator().manual_seed(13))
    assert (state.info["traj"].shape[-1], state.obs.shape[-1],
            env.action_size) == tuple(cfg["sizes"].values())
    ref_state = judge.to_reference(state)
    draws = torch.Generator().manual_seed(14)
    for _ in range(2):
        action = 2 * torch.rand(2, env.action_size, generator=draws) - 1
        state = env.step(state, action)
        ref_state = ref.step(ref_state, action)
        for name in ("qpos", "qvel"):
            assert _gap(getattr(state.pipeline_state, name),
                        getattr(ref_state.pipeline_state, name)) <= 1e-5, name
        assert _gap(state.obs, ref_state.obs) <= 1e-5
        assert _gap(state.reward[:, None], ref_state.reward[:, None]) <= 1e-5
        assert torch.equal(state.done, ref_state.done)


def test_other_reference_envs_keep_ten_pair_types():
    """Only envs/cmu_humanoid.py registers the convex pairs: a process
    that imports the reference's rodent and humanoid envs keeps the JAX
    package's ten pair types (the module registry is per process, so a
    fresh one), and registering them afterwards, as a process that also
    judges the CMU humanoid does, leaves the reference humanoid's control
    step bit for bit as it was."""
    code = (
        "import torch\n"
        "from benchmark.reference.plain.envs import rodent, humanoid\n"
        "from benchmark.reference.plain.physics import collision, convex\n"
        "print(len(collision._ORDER), len(collision._NARROWPHASE))\n"
        "env = humanoid.make_humanoid_env(device='cpu')\n"
        "def step():\n"
        "    st = env.reset(2, generator=torch.Generator().manual_seed(3))\n"
        "    a = torch.rand(2, env.action_size,\n"
        "                   generator=torch.Generator().manual_seed(4))\n"
        "    st = env.step(st, 2 * a - 1)\n"
        "    return torch.cat([st.pipeline_state.qpos, st.pipeline_state.qvel,\n"
        "                      st.obs], -1)\n"
        "before = step()\n"
        "convex.register()\n"
        "print(len(collision._ORDER), torch.equal(before, step()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["10", "10", "13", "True"]


def test_kernel_e_tables_of_the_cmu_humanoid():
    """945 candidate pairs and 982 slots; the convex instantiation of
    kernel E; the pair groups a capture notes; kernel B's widest route at
    3,984 rows."""
    m = tmjcf.load_model(compat.CMU_HUMANOID_XML, device="cpu")
    t = col_ops.kernel_tables(m)
    assert (len(t["pair"]), len(t["con_pair"])) == (945, 982)
    assert (t["boxes"], t["convex"]) == (False, True)
    assert t["route"] == col_ops.ROUTES["convex"]
    assert t["pair_groups"] == dict(plane=45, body=825, box=0, convex=75)
    assert int(kernel_bench.convex_slots(m, t["con_pair"]).sum()) == 75
    assert m.nlimit + 4 * m.ncon_max == 3984


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [7, 1000])
def test_kernel_e_convex_pairs_on_the_cmu_humanoid(cuda, batch):
    """Kernel E on the CMU humanoid dropped near the floor with random
    limbs (kernel_bench.collision_states): every slot held by
    kernel_bench.check_collision, the convex ones by check_convex; one
    launch, the same bits from a second."""
    m = tmjcf.load_model(compat.CMU_HUMANOID_XML, device="cuda")
    mc = tmjcf.load_model(compat.CMU_HUMANOID_XML, device="cpu")
    qpos = torch.as_tensor(kernel_bench.collision_states(
        mc.qpos0.numpy(), mc.jnt_range.numpy(), True, batch, batch),
        device="cuda")
    d = kinematics.kinematics(m, forward.make_data(m, batch, qpos=qpos))
    gx, gm = d.geom_xpos.contiguous(), d.geom_xmat.contiguous()
    before = launch_counts["collision"]
    got = col_ops._launch(m, gx, gm)
    assert launch_counts["collision"] == before + 1
    for g, a in zip(got[:3], col_ops._launch(m, gx, gm)[:3]):
        assert torch.equal(g, a)
    dc = d.replace(qpos=d.qpos.cpu(), geom_xpos=gx.cpu(), geom_xmat=gm.cpu())
    errs = kernel_bench.check_collision(got, mc, dc)
    assert "convex_shortfall" in errs
    assert col_ops.resources(m)["takes"] == "convex"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_e_convex_pairs_where_cores_overlap(cuda, kind):
    """Kernel E on deep_convex_poses, an env a pose: every distance at or
    above the grid's greatest gap within float32 rounding (2e-5, the
    narrowphase tests' tolerance), and the slots held by check_collision
    (check_convex: the distance within 2e-5 of the plain float32 one, the
    gap along the kernel's normal within 2e-5 of the plain float64
    distance)."""
    xml = kernel_bench.deep_convex_scene(kind)
    m = tmjcf.load_model(xml, device="cuda")
    mc = tmjcf.load_model(xml, device="cpu")
    (x, R), grid = kernel_bench.deep_convex_poses(
        kind, DEEP_POSES, seed=31 + KINDS.index(kind))
    gx = x.float().contiguous().cuda()
    gm = R.float().contiguous().cuda()
    got = col_ops._launch(m, gx, gm)
    assert float((grid - got[0][:, 0].double().cpu()).max()) <= 2e-5
    d = forward.make_data(mc, DEEP_POSES).replace(
        geom_xpos=gx.cpu(), geom_xmat=gm.cpu())
    errs = kernel_bench.check_collision(got, mc, d)
    assert "convex_shortfall" in errs


@pytest.mark.cuda
def test_kernel_b_widest_route_on_the_cmu_humanoid(cuda):
    """Kernel B's widest route, cg_kernel<0>, at the CMU system (56 limits
    and 982 contact slots: 3,984 rows) on 128 contact states, held by
    kernel_bench.check_cg_widest; two planted faults fail it: the kernel
    with one CG iteration fewer, and fed g off by 1e-4 relative.  Counted
    as cg_widest; the same bits twice."""
    import dataclasses
    m, kw = kernel_bench.scene("cmu", "cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    (args, st), active = kernel_bench.contact_states(m, 128, gen,
                                                     press=kw["press"])
    assert active > 0 and st.nlimit + 4 * st.ncon == 3984
    assert cg_ops.kernel_name(st) == "cg_kernel<0>"
    before = launch_counts["cg_widest"]
    got = cg_ops._launch(st, args)
    assert launch_counts["cg_widest"] == before + 1
    kernel_bench.check_cg_widest(st, args, got)
    for g, a in zip(got, cg_ops._launch(st, args)):
        assert torch.equal(g, a)
    fewer = dataclasses.replace(st, iters=st.iters - 1, cache={})
    with pytest.raises(AssertionError):
        kernel_bench.check_cg_widest(st, args, cg_ops._launch(fewer, args))
    off = list(args)
    off[4] = args[4] * (1.0 + 1e-4 * torch.randn(
        args[4].shape, generator=gen, device="cuda"))
    with pytest.raises(AssertionError):
        kernel_bench.check_cg_widest(st, args, cg_ops._launch(st, off))
    res = cg_ops.resources(st)
    assert res["smem_bytes"] <= 227 * 1024 and res["local_bytes"] == 0
