"""RK4 and the full implicit integrator of vnl_tpu_torch against vnl_tpu's
physics.step on the CPU, one step and five steps from the same state:
gymnasium's ant (RK4 from its XML, Newton 1 iteration / 4 line-search
rounds as AntTracking compiles it; and the same with integrator="implicit")
and dm_control's humanoid (CG, pyramidal, Euler in its XML; here with
integrator="RK4" and "implicit"), feet pressed into the floor.  The
humanoid's CG runs to convergence (50 iterations): the implicit step
integrates qfrc_constraint, not qacc, and a few CG iterations on its stiff
contacts leave forces that move with float32 rounding by more than the
forward tolerance (tests/test_torch_newton.py).
Also refine_inv_general against the JAX package's on an unsymmetric
matrix, and the implicit step's Jacobian (torch.func.jacfwd of the
velocity forces, batched by summing over envs) against jax.jacfwd per env.

Tolerances: one step moves qvel by h qacc and qpos by h^2 qacc, so the
forward tolerance of qacc (5e-3, tests/test_pallas_cg.py:173-174) becomes
qvel rtol = atol = 1e-3 and qpos atol 1e-4 (h = 5 or 10 ms); after five
steps the differences compound through the contacts to qvel rtol = atol
= 5e-3 and qpos atol 2e-4.  The Jacobian and refine_inv_general are
float32 evaluations of the same formulas: rtol 1e-4, atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu_torch.ops import linalg as tlinalg
from vnl_tpu_torch.physics import forward as tfwd
from vnl_tpu_torch.physics.model import IntegratorType

import torch_parity as tp

B = 3

CASES = {
    "ant_rk4": (tp.ANT_XML, dict(solver="newton", iterations=1,
                                 ls_iterations=4)),
    "ant_implicit": (tp.ANT_XML, dict(solver="newton", iterations=1,
                                      ls_iterations=4,
                                      integrator="implicit")),
    "humanoid_rk4": (tp.HUMANOID_XML, dict(solver="cg", iterations=50,
                                           ls_iterations=10,
                                           integrator="RK4")),
    "humanoid_implicit": (tp.HUMANOID_XML, dict(
        solver="cg", iterations=50, ls_iterations=10,
        integrator="implicit")),
}


def _states(name, jm):
    if name.startswith("ant"):
        return tp.perturbed_states(jm, B, seed=13, press=0.55,
                                   joint_scale=0.2, vel_scale=0.3)
    return tp.perturbed_states(jm, B, seed=14, press=0.215,
                               joint_scale=0.1, vel_scale=0.3)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(name, {1: (JAX, torch) Data after one step, 5: after five})."""
    name = request.param
    path, overrides = CASES[name]
    jm = tp.jax_scene(path, **overrides)
    want = {"rk4": IntegratorType.RK4,
            "implicit": IntegratorType.IMPLICIT}[name.split("_")[1]]
    assert jm.opt.integrator == int(want)
    tm = tp.torch_model(jm)
    qpos, qvel = _states(name, jm)
    physics = tp.jax_module("vnl_tpu.physics")
    jstep = jax.jit(jax.vmap(lambda x: physics.step(jm, x)))
    d = jax.vmap(lambda q, v: physics.make_data(jm, qpos=q, qvel=v))(
        jnp.asarray(qpos), jnp.asarray(qvel))
    td = tfwd.make_data(tm, B, qpos=torch.as_tensor(qpos),
                        qvel=torch.as_tensor(qvel))
    out = {}
    for n in range(1, 6):
        d, td = jstep(d), tfwd.step(tm, td)
        out[n] = (d, td)
    return name, out


@pytest.mark.parametrize("nsteps", [1, 5])
def test_steps_match(case, nsteps):
    name, out = case
    d, td = out[nsteps]
    assert bool((td.contact_dist < 0).any())
    qtol, vtol = (1e-4, 1e-3) if nsteps == 1 else (2e-4, 5e-3)
    tp.assert_close(td.qpos, d.qpos, 0.0, qtol, f"{name} qpos")
    tp.assert_close(td.qvel, d.qvel, vtol, vtol, f"{name} qvel")
    # the derived fields are the last forward pass's (RK4: its 4th stage)
    tp.assert_close(td.qacc, d.qacc, 5e-3 * nsteps, 5e-3 * nsteps,
                    f"{name} qacc")


def test_refine_inv_general_matches():
    jlinalg = tp.jax_module("vnl_tpu.ops.linalg")
    rng = np.random.default_rng(15)
    a = np.eye(14) * 3 + 0.3 * rng.normal(size=(4, 14, 14))
    x0 = np.linalg.inv(a) + 1e-3 * rng.normal(size=a.shape)
    a, x0 = a.astype(np.float32), x0.astype(np.float32)
    want = jlinalg.refine_inv_general(jnp.asarray(a), jnp.asarray(x0), 6)
    got = tlinalg.refine_inv_general(torch.as_tensor(a), torch.as_tensor(x0),
                                     6)
    tp.assert_close(got, want, 1e-4, 1e-4, "refine_inv_general")
    eye = np.eye(14, dtype=np.float32)
    assert np.abs(a @ got.numpy() - eye).max() < 1e-4


def test_velocity_jacobian_matches():
    """qDeriv of the implicit step: the port's batched jacfwd equals
    jax.jacfwd of the JAX package's _vel_forces env by env."""
    jfwd = tp.jax_module("vnl_tpu.physics.forward")
    path, overrides = CASES["ant_implicit"]
    jm = tp.jax_scene(path, **overrides)
    tm = tp.torch_model(jm)
    qpos, qvel = _states("ant", jm)
    rng = np.random.default_rng(16)
    ctrl = rng.uniform(-1, 1, size=(B, jm.nu)).astype(np.float32)
    physics = tp.jax_module("vnl_tpu.physics")
    d = jax.jit(jax.vmap(lambda q, v, c: physics.forward(
        jm, physics.make_data(jm, qpos=q, qvel=v).replace(ctrl=c))))(
            jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl))
    want = jax.jit(jax.vmap(lambda x: jax.jacfwd(
        lambda v: jfwd._vel_forces(jm, x, v))(x.qvel)))(d)
    td = tp.data_to_torch(d)
    from vnl_tpu_torch.physics import actuation
    actuation.activation_mask(tm)       # as _implicit_integrate does
    got = torch.func.jacfwd(
        lambda v: tfwd._vel_forces(tm, td, v).sum(0))(td.qvel)
    tp.assert_close(got.permute(1, 0, 2), want, 1e-4, 1e-4, "qDeriv")
