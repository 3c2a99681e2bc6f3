"""The Newton solver, the elliptic cone and CG on the dense Jacobian of
vnl_tpu_torch against vnl_tpu's forward() on the CPU: gymnasium's ant
(floor contacts, condim 3) at AntTracking's setting (Newton, 1 iteration,
4 line-search rounds) and with the elliptic cone; dm_control's humanoid
(feet on the floor, condim 3, and limbs touching each other, condim 1)
with Newton and CG, pyramidal and elliptic; the contact-only box scene
(no limit rows) with Newton.

Tolerances: qacc rtol = atol = 5e-3 and qfrc_constraint rtol 5e-3 / atol
5e-2, the JAX tests' forward tolerance (tests/test_pallas_cg.py:173-177).
On the humanoid the solves run to convergence (30 Newton or 50 CG
iterations): a few iterations from qacc_smooth on its stiff contacts leave
an iterate whose active set, and so its value, moves with float32 rounding
(the port in float32 is then as far from the port in float64 as from the
JAX package), while the converged solution is unique.  The ant at its env
setting has no such spread and is compared at 1 iteration."""

import numpy as np
import pytest
import torch

from vnl_tpu_torch.ops import cg as cg_ops
from vnl_tpu_torch.physics import constraint as tcon
from vnl_tpu_torch.physics import forward as tfwd
from vnl_tpu_torch.physics import solver as tsolver

import torch_parity as tp

B = 4

CASES = {
    "ant_newton": (tp.ANT_XML, dict(solver="newton", iterations=1,
                                    ls_iterations=4)),
    "ant_newton_elliptic": (tp.ANT_XML, dict(
        solver="newton", iterations=4, ls_iterations=4, cone="elliptic")),
    "ant_cg_elliptic": (tp.ANT_XML, dict(
        solver="cg", iterations=6, ls_iterations=6, cone="elliptic")),
    "humanoid_newton": (tp.HUMANOID_XML, dict(
        solver="newton", iterations=30, ls_iterations=10)),
    "humanoid_newton_elliptic": (tp.HUMANOID_XML, dict(
        solver="newton", iterations=30, ls_iterations=10, cone="elliptic")),
    "humanoid_cg_elliptic": (tp.HUMANOID_XML, dict(
        solver="cg", iterations=50, ls_iterations=10, cone="elliptic")),
}


def _states(name, jm):
    if name.startswith("ant"):
        # the torso pressed 0.6 below its rest height: feet in the floor
        return tp.perturbed_states(jm, B, seed=3, press=0.6, joint_scale=0.3)
    # feet 5-15 mm into the floor, limbs bent into each other
    return tp.perturbed_states(jm, B, seed=5, press=0.22, joint_scale=0.3,
                               vel_scale=0.3)


@pytest.fixture(scope="module", params=sorted(CASES))
def solved(request):
    name = request.param
    path, overrides = CASES[name]
    jm = tp.jax_scene(path, **overrides)
    qpos, qvel = _states(name, jm)
    d = tp.jax_forward(jm, qpos, qvel)
    tm = tp.torch_model(jm)
    td = tfwd.forward(tm, tfwd.make_data(tm, B, qpos=torch.as_tensor(qpos),
                                         qvel=torch.as_tensor(qvel)))
    return name, jm, d, td


def test_qacc_matches(solved):
    name, jm, d, td = solved
    floor = np.asarray(jm.pair_dim)[tp.jax_module(
        "vnl_tpu.physics.collision").pair_expansion(jm)] == 3
    assert bool((td.contact_dist[:, torch.as_tensor(floor)] < 0).any())
    if name.startswith("humanoid"):      # condim-1 rows are active too
        assert bool((td.contact_dist[:, torch.as_tensor(~floor)] < 0).any())
    tp.assert_close(td.qacc, d.qacc, 5e-3, 5e-3, f"{name} qacc")


def test_qfrc_constraint_matches(solved):
    name, _, d, td = solved
    tp.assert_close(td.qfrc_constraint, d.qfrc_constraint, 5e-3, 5e-2,
                    f"{name} qfrc_constraint")


def test_contact_force_matches(solved):
    """Per-contact forces (facets, or (n, t1, t2, 0) for elliptic rows) at
    the qfrc_constraint tolerance."""
    name, _, d, td = solved
    assert td.contact_force.shape == tuple(d.contact_force.shape)
    tp.assert_close(td.contact_force, d.contact_force, 5e-3, 5e-2,
                    f"{name} contact_force")


def test_newton_contact_only_box():
    """Newton on the contact-only box (nlimit 0, 4 plane-box points)."""
    jm = tp.jax_scene(tp.CONTACT_BOX, solver="newton", iterations=8,
                      ls_iterations=8)
    qpos, qvel = tp.perturbed_states(jm, B, seed=9, vel_scale=0.3)
    rng = np.random.default_rng(10)
    qpos[:, 2] -= 0.01 * rng.uniform(size=B).astype(np.float32)
    d = tp.jax_forward(jm, qpos, qvel)
    tm = tp.torch_model(jm)
    td = tfwd.forward(tm, tfwd.make_data(tm, B, qpos=torch.as_tensor(qpos),
                                         qvel=torch.as_tensor(qvel)))
    assert jm.nlimit == 0 and bool((td.contact_dist < 0).any())
    tp.assert_close(td.qacc, d.qacc, 5e-3, 5e-3, "qacc")


@pytest.mark.parametrize("case", ["ant_newton", "ant_cg_elliptic",
                                  "humanoid_cg_elliptic"])
def test_dense_jacobian_built_as_in_jax(case):
    """con_Jc is dense exactly for Newton or the elliptic cone, and its
    products equal the factored form's."""
    path, overrides = CASES[case]
    jm = tp.jax_scene(path, **overrides)
    tm = tp.torch_model(jm)
    qpos, qvel = _states(case, jm)
    d = tfwd.make_data(tm, B, qpos=torch.as_tensor(qpos),
                       qvel=torch.as_tensor(qvel))
    d, efc = tfwd.fwd_position(tm, d)
    assert efc.con_Jc is not None and efc.con_Jc.shape == (B, jm.ncon_max,
                                                            3, jm.nv)
    args = (tm, d, d.contact_dist, d.contact_pos, d.contact_frame,
            tcol_pairs(tm))
    factored = tcon.make_constraints(*args, materialize_jc=False)
    assert factored.con_Jc is None
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(B, jm.nv)).astype(np.float32))
    for a, b in zip(efc.jx(x), factored.jx(x)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    f = torch.rand(B, jm.ncon_max, efc.ncon_rows)
    lf = torch.rand(B, efc.nlimit)
    torch.testing.assert_close(efc.jt_f(lf, f), factored.jt_f(lf, f),
                               rtol=1e-5, atol=1e-4)


def tcol_pairs(tm):
    from vnl_tpu_torch.physics import collision
    return collision.pair_expansion(tm)


def test_pyramidal_cg_stays_factored():
    """CG with the pyramidal cone keeps the factored system (kernel B's
    input), as the humanoid envs run it."""
    jm = tp.jax_scene(tp.HUMANOID_XML, solver="cg", iterations=6,
                      ls_iterations=6)
    tm = tp.torch_model(jm)
    qpos, qvel = _states("humanoid", jm)
    _, efc = tfwd.fwd_position(tm, tfwd.make_data(
        tm, B, qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel)))
    assert efc.con_Jc is None and efc.ncon_rows == 4


def test_elliptic_cg_skips_kernel_b(monkeypatch):
    """An elliptic CG solve runs the plain dense loop, never kernel B's
    wrapper (the JAX package's fused solve wants a factored system)."""
    def refuse(*a, **k):
        raise AssertionError("kernel B called for an elliptic solve")

    monkeypatch.setattr(cg_ops, "_launch", refuse)
    monkeypatch.setattr(cg_ops, "cg_plain", refuse)
    path, overrides = CASES["ant_cg_elliptic"]
    jm = tp.jax_scene(path, **overrides)
    tm = tp.torch_model(jm)
    qpos, qvel = _states("ant", jm)
    td = tfwd.forward(tm, tfwd.make_data(tm, B, qpos=torch.as_tensor(qpos),
                                         qvel=torch.as_tensor(qvel)))
    assert bool(torch.isfinite(td.qacc).all())


def test_newton_inverse_on_cpu_is_plain_schur():
    """On a CPU tensor Newton's H^-1 is ops/linalg.inv_spd."""
    from vnl_tpu_torch.ops import linalg
    a = torch.randn(3, 14, 14)
    h = a @ a.transpose(1, 2) + 14 * torch.eye(14)
    torch.testing.assert_close(tsolver.inv_spd(h), linalg.inv_spd(h),
                               rtol=0, atol=0)
