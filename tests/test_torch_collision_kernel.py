"""Kernel E (ops/collision.py, csrc/collision.cu), the narrowphase of every
candidate pair in one launch: its static tables on the CPU, and the
kernel against the plain narrowphase (collision.collide_plain) on a CUDA
device (marked ``cuda``; skipped without a card, since a CUDA kernel has
no CPU mode).  Imports neither JAX nor vnl_tpu, so it also runs where
only the port is installed:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_collision_kernel.py -m cuda

The yardstick is the plain version on the CPU, the CPU's path, on the
card's geoms: the kernel rounds each operation on its own and sums three
terms left to right as it does.  (The plain version on the card sums
three terms as (a + c) + b, and where two capsules' axes nearly meet
that moves a contact frame by up to 8e-5.)  Tolerances are those of
tests/test_torch_collision_pairs.py: distances, points and frames at
atol 2e-5 (float32 geometry of O(1) values, the same formulas).
Plane-box and box-box keep their deepest candidates: per pair the kept
depths must agree and each kept point must be one of the plain version's
candidates, one to one, so that points a few ulps apart may trade slots
or, tied at the last kept depth, trade places with a candidate left out.
Exact ties (env 0 of the box scene lies flat) land in the plain version's
slots."""

import numpy as np
import pytest
import torch

from vnl_tpu_torch import compat, kernel_bench, mjcf
from vnl_tpu_torch.ops import collision as col_ops
from vnl_tpu_torch.ops import launch_counts
from vnl_tpu_torch.physics import collision, forward, kinematics

# the scenes of test_pair_expansion_matches and the twin
SCENES = {"boxes": kernel_bench.BOX_SCENE, "round": kernel_bench.ROUND_SCENE,
          "ellipsoid": kernel_bench.ELLIPSOID_SCENE,
          "humanoid": compat.DM_HUMANOID_XML,
          "ant": compat.GYM_ANT_XML, "twin": None}


def _model(name, device):
    if name == "twin":
        return compat.model_from_numpy(compat.TWIN_MODEL, device=device)
    return mjcf.load_model(SCENES[name], device=device)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_slots_reproduce_pair_expansion(name):
    """Each row's points by the kernel's rule (first slot + j * stride)
    fill every contact slot once, with the pair pair_expansion names."""
    m = _model(name, "cpu")
    t = col_ops.kernel_tables(m)
    want = collision.pair_expansion(m)
    types, first, stride = (t["pair_int"][col_ops.PAIR_FIELDS.index(f)]
                            for f in ("type", "slot", "stride"))
    got = np.full(len(want), -1)
    for row, ty, s0, ds in zip(t["pair"], types, first, stride):
        s = s0 + ds * np.arange(collision._ORDER[ty][2])
        assert (got[s] == -1).all(), (name, row)
        got[s] = row
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t["con_pair"], want)
    assert t["pair_int"].shape == (len(col_ops.PAIR_FIELDS), len(t["pair"]))
    np.testing.assert_array_equal(
        t["pair_size"], np.concatenate(
            [m.geom_size.numpy()[np.asarray(m.pair_geom1)[t["pair"]]],
             m.geom_size.numpy()[np.asarray(m.pair_geom2)[t["pair"]]]], 1).T)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_box_instantiation_only_where_boxes_collide(name):
    """The kBoxes instantiation for the box scene alone: the twin, the
    humanoid and the ant take the one without box pairs."""
    assert col_ops.kernel_tables(_model(name, "cpu"))["boxes"] == \
        (name == "boxes")


def test_cpu_collide_is_the_plain_version():
    m = _model("round", "cpu")
    q = torch.as_tensor(kernel_bench.collision_states(
        m.qpos0.numpy(), m.jnt_range.numpy(), False, 3, 5))
    d = kinematics.kinematics(m, forward.make_data(m, 5, qpos=q))
    before = launch_counts["collision"]
    got, want = collision.collide(m, d), collision.collide_plain(m, d)
    assert launch_counts["collision"] == before
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(got[3], want[3])


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return "cuda"


def _geoms(m, name, batch, seed):
    """Data with the geoms' poses of ``batch`` random states (the twin's
    root lowered into the floor)."""
    if name == "twin":
        gen = torch.Generator(device="cuda").manual_seed(seed)
        qpos = kernel_bench.random_states(m, batch, gen)
        qpos[:, 2] -= 0.02
    else:
        qpos = torch.as_tensor(kernel_bench.collision_states(
            m.qpos0.cpu().numpy(), m.jnt_range.cpu().numpy(),
            name == "humanoid", seed, batch), device="cuda")
    return kinematics.kinematics(m, forward.make_data(m, batch, qpos=qpos))


def _check(m, name, d):
    """Kernel E against collide_plain on the CPU on ``d``'s geoms
    (kernel_bench.check_collision): one launch counted, the same bits from
    a second launch.  Returns the plain version's contacts."""
    gx, gm = d.geom_xpos.contiguous(), d.geom_xmat.contiguous()
    before = launch_counts["collision"]
    got = col_ops.collide(m, gx, gm)
    assert launch_counts["collision"] == before + 1
    again = col_ops.collide(m, gx, gm)
    for k, field in enumerate(("dist", "pos", "frame")):
        assert got[k].is_contiguous() and got[k].dtype == torch.float32
        assert torch.equal(got[k], again[k]), field
    mc = _model(name, "cpu")
    dc = d.replace(qpos=d.qpos.cpu(), geom_xpos=gx.cpu(), geom_xmat=gm.cpu())
    kernel_bench.check_collision(got, mc, dc, flat_env=name == "boxes")
    return collision.collide_plain(mc, dc)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7, 128, 1000])
@pytest.mark.parametrize("name", ["boxes", "round", "ellipsoid", "humanoid",
                                  "twin"])
def test_collision_kernel_matches_plain(cuda, name, batch):
    """All ten pair types (boxes, round and ellipsoid hold them between
    them), the humanoid's 161 pairs and the twin's 16."""
    m = _model(name, "cuda")
    want = _check(m, name, _geoms(m, name, batch, seed=batch))
    assert batch < 128 or bool((want[0] < 0).any())     # some touch


@pytest.mark.cuda
def test_collision_kernel_resources(cuda):
    """Both instantiations build and report their registers; the humanoid
    takes the one without box pairs, the box scene the other."""
    for name, takes in (("humanoid", "no_boxes"), ("boxes", "boxes")):
        res = col_ops.resources(_model(name, "cuda"))
        assert res["takes"] == takes
        for inst in ("boxes", "no_boxes"):
            assert res[inst]["regs"] > 0 and res[inst]["blocks_per_sm"] > 0


@pytest.mark.cuda
def test_collision_kernel_rejects_bad_inputs(cuda):
    m = _model("humanoid", "cuda")
    d = _geoms(m, "humanoid", 4, seed=1)
    gx, gm = d.geom_xpos.contiguous(), d.geom_xmat.contiguous()
    with pytest.raises(ValueError, match="geom_xpos"):
        col_ops.collide(m, gx.double(), gm)
    with pytest.raises(ValueError, match="geom_xmat"):
        col_ops.collide(m, gx, gm.double())
    with pytest.raises(ValueError, match="geom_xmat"):
        col_ops.collide(m, gx, gm.transpose(-1, -2))
    with pytest.raises(ValueError, match="geom_xpos"):
        col_ops.collide(m, gx.cpu(), gm)
    with pytest.raises(ValueError, match="geom_xpos"):
        collision.collide(m, d.replace(geom_xpos=gx.double(),
                                       geom_xmat=gm.double()))


@pytest.mark.cuda
def test_collision_launches_a_control_step(cuda):
    """Kernel E once a forward pass: 5 a control step of the twin and the
    humanoid, 20 of the ant (RK4's four passes a substep)."""
    from vnl_tpu_torch.envs import (AntTracking, HumanoidTracking,
                                    make_twin_env)
    for env, want in ((make_twin_env(device="cuda"), 5),
                      (HumanoidTracking(device="cuda"), 5),
                      (AntTracking(device="cuda"), 20)):
        state = env.reset(8, generator=torch.Generator(
            device="cuda").manual_seed(6))
        launch_counts.clear()
        state = env.step(state, torch.zeros(8, env.action_size,
                                            device="cuda"))
        assert launch_counts["collision"] == want
        assert bool(torch.isfinite(state.pipeline_state.qpos).all())
