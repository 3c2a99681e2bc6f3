"""The unfused position stage of vnl_tpu_torch against vnl_tpu's: crb and
invert_mass_matrix, exact and refining, on the rodent twin and on the box
with a damped hinged child, and a 5-substep pipeline_step with
fused_position=False against the JAX env's pipeline_step, which takes the
same path on the CPU (first substep exact, the other four refined), on the
twin and on the undamped sphere-on-plate scene (one inverse).

Tolerances: qM 2e-5 (tests/test_pallas_position.py:43-44).  The exact
inverses are two different fp32 algorithms on an ill-conditioned matrix
(the port's sweep, the JAX package's Schur inverse on the CPU), so they
compare at rtol 5e-3 / atol 1e-4 of the inverse's scale and each must
invert its matrix to |A X - I| < 5e-3 (tests/test_pallas_position.py:48-60).
The refined inverses start from the same seed and run the same products:
1e-4 of the scale.  pipeline_step: qpos 1e-5, qvel rtol/atol 1e-3 and qacc
5e-3, as tests/test_torch_forward.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu.envs.base import PipelineEnv as JPipelineEnv
from vnl_tpu_torch.envs.base import PipelineEnv as TEnv
from vnl_tpu_torch.ops import launch_counts
from vnl_tpu_torch.physics import inertia as tinertia

import torch_parity as tp
from test_torch_forward import _scene as contact_scene

B = 3
jinertia = tp.jax_module("vnl_tpu.physics.inertia")


def _scene(name):
    jm = tp.jax_twin() if name == "twin" else tp.jax_box_chain()
    qpos, qvel = tp.perturbed_states(jm, B, seed=8, press=0.005)
    return jm, qpos, qvel


def _hB(jm):
    return np.diag(jm.opt.timestep * np.asarray(jm.dof_damping))


@pytest.mark.parametrize("scene", ["twin", "box_chain"])
def test_crb_exact_matches(scene):
    jm, qpos, qvel = _scene(scene)
    tm = tp.torch_model(jm)
    d = tp.jax_forward(jm, qpos, qvel)
    want = jax.jit(jax.vmap(lambda x: jinertia.crb(jm, x)))(d)
    td = tp.data_to_torch(d)
    zero = torch.zeros_like(td.qM)
    got = tinertia.crb(tm, td.replace(qM=zero, qMinv=zero, qMhBinv=zero))
    tp.assert_close(got.qM, want.qM, 2e-5, 2e-5, "qM")
    eye = np.eye(jm.nv)
    for name, A in (("qMinv", np.asarray(want.qM)),
                    ("qMhBinv", np.asarray(want.qM) + _hB(jm))):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        np.testing.assert_allclose(g, w, rtol=5e-3,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
        assert np.abs(A @ g - eye).max() < 5e-3, name
    assert tinertia.needs_implicit_damping(tm)
    assert not torch.equal(got.qMinv, got.qMhBinv)


@pytest.mark.parametrize("scene", ["twin", "box_chain"])
def test_invert_mass_matrix_refining_matches(scene):
    """The carried inverses of a nearby state (the seed a substep leaves)
    polished against this state's qM."""
    jm, qpos, qvel = _scene(scene)
    tm = tp.torch_model(jm)
    d = tp.jax_forward(jm, qpos, qvel)
    qpos2 = qpos.copy()
    qpos2[:, 7:] += 0.002
    d2 = tp.jax_forward(jm, qpos2, qvel)
    seeded = d2.replace(qMinv=d.qMinv, qMhBinv=d.qMhBinv)
    want = jax.jit(jax.vmap(
        lambda x: jinertia.invert_mass_matrix(jm, x, True)))(seeded)
    before = launch_counts["sweep"]
    got = tinertia.invert_mass_matrix(tm, tp.data_to_torch(seeded), True)
    assert launch_counts["sweep"] == before
    for name in ("qMinv", "qMhBinv"):
        w = np.asarray(getattr(want, name))
        scale = np.abs(w).max()
        np.testing.assert_allclose(getattr(got, name).numpy() / scale,
                                   w / scale, atol=1e-4, err_msg=name)


def test_invert_mass_matrix_undamped_has_one_inverse():
    jm = tp.jax_box()
    tm = tp.torch_model(jm)
    qpos, qvel = tp.perturbed_states(jm, B, seed=9)
    d = tp.jax_forward(jm, qpos, qvel)
    want = jax.jit(jax.vmap(lambda x: jinertia.crb(jm, x)))(d)
    got = tinertia.crb(tm, tp.data_to_torch(d))
    assert not tinertia.needs_implicit_damping(tm)
    assert got.qMhBinv is got.qMinv
    w = np.asarray(want.qMinv)
    np.testing.assert_allclose(got.qMinv.numpy(), w, rtol=5e-3,
                               atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("scene", ["twin", "box"])
def test_pipeline_step_unfused_matches(scene):

    class JEnv(JPipelineEnv):
        reset = step = None

    jm, qpos, qvel = contact_scene(scene)
    qpos, qvel = qpos[:B], qvel[:B]
    tm = tp.torch_model(jm)
    rng = np.random.default_rng(7)
    ctrl = rng.uniform(-1, 1, size=(B, jm.nu)).astype(np.float32)
    jenv = JEnv(jm, n_frames=5)
    tenv = TEnv(tm, n_frames=5, fused_position=False)
    assert not tenv.fused_position
    d0 = tp.jax_forward(jm, qpos, qvel)
    d = jax.jit(jax.vmap(jenv.pipeline_step))(d0, jnp.asarray(ctrl))
    td = tenv.pipeline_step(tp.data_to_torch(d0), torch.as_tensor(ctrl))
    assert np.isfinite(td.qpos.numpy()).all()
    tp.assert_close(td.qpos, d.qpos, 1e-5, 1e-5, "qpos")
    tp.assert_close(td.qvel, d.qvel, 1e-3, 1e-3, "qvel")
    tp.assert_close(td.qacc, d.qacc, 5e-3, 5e-3, "qacc")
    eye = torch.eye(jm.nv)
    hB = torch.as_tensor(_hB(jm), dtype=torch.float32)
    assert float((td.qM @ td.qMinv - eye).abs().max()) < 5e-3
    assert float(((td.qM + hB) @ td.qMhBinv - eye).abs().max()) < 5e-3
