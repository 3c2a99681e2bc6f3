"""forward() and a 5-substep pipeline_step of vnl_tpu_torch against
vnl_tpu on the rodent twin (states pressed into the floor) and on the box
scene with the sphere on the plate (sphere-box contact).

Tolerances: qacc 5e-3 and qfrc_constraint rtol 5e-3 / atol 5e-2, as
tests/test_pallas_cg.py:173-177 holds the fused solver to the XLA one (the
port runs the exact position stage and the factored CG; the JAX package on
the CPU runs the dense-Jacobian CG and, inside pipeline_step, refines the
carried mass-matrix inverses instead of refactoring them).  After five
substeps the state differs by those qacc differences times dt:
qpos within 1e-5 and qvel within rtol 1e-3 / atol 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu_torch.envs.base import PipelineEnv as TEnv
from vnl_tpu_torch.physics import forward as tfwd

import torch_parity as tp

B = 4


def _scene(name):
    if name == "twin":
        jm = tp.jax_twin()
        qpos, qvel = tp.perturbed_states(jm, B, seed=5, press=0.005)
    else:
        jm = tp.jax_box("sphere", "0.09", "0 0 0.285", solver="cg",
                        iterations=6, ls_iterations=6, cone="pyramidal")
        qpos, qvel = tp.perturbed_states(jm, B, seed=5, vel_scale=0.3)
        rng = np.random.default_rng(6)
        qpos[:, :3] += (0.01 * rng.normal(size=(B, 3))).astype(np.float32)
    return jm, qpos, qvel


@pytest.mark.parametrize("scene", ["twin", "box"])
def test_forward_matches(scene):
    jm, qpos, qvel = _scene(scene)
    tm = tp.torch_model(jm)
    d = tp.jax_forward(jm, qpos, qvel)
    td = tfwd.forward(tm, tfwd.make_data(tm, B, qpos=torch.as_tensor(qpos),
                                         qvel=torch.as_tensor(qvel)))
    assert bool((td.contact_dist < 0).any())
    for name in ("contact_dist", "contact_pos", "qfrc_bias",
                 "qfrc_passive", "qfrc_actuator"):
        tp.assert_close(getattr(td, name), getattr(d, name), 2e-5, 2e-5,
                        name)
    tp.assert_close(td.qacc_smooth, d.qacc_smooth, 5e-3, 5e-3, "qacc_smooth")
    tp.assert_close(td.qacc, d.qacc, 5e-3, 5e-3, "qacc")
    tp.assert_close(td.qfrc_constraint, d.qfrc_constraint, 5e-3, 5e-2,
                    "qfrc_constraint")


@pytest.mark.parametrize("scene", ["twin", "box"])
def test_pipeline_step_matches(scene):
    from vnl_tpu.envs.base import PipelineEnv

    class JEnv(PipelineEnv):
        reset = step = None

    jm, qpos, qvel = _scene(scene)
    tm = tp.torch_model(jm)
    rng = np.random.default_rng(7)
    ctrl = rng.uniform(-1, 1, size=(B, jm.nu)).astype(np.float32)
    jenv, tenv = JEnv(jm, n_frames=5), TEnv(tm, n_frames=5)
    d0 = tp.jax_forward(jm, qpos, qvel)
    d = jax.jit(jax.vmap(jenv.pipeline_step))(d0, jnp.asarray(ctrl))
    td = tenv.pipeline_step(tp.data_to_torch(d0), torch.as_tensor(ctrl))
    assert np.isfinite(td.qpos.numpy()).all()
    tp.assert_close(td.qpos, d.qpos, 1e-5, 1e-5, "qpos")
    tp.assert_close(td.qvel, d.qvel, 1e-3, 1e-3, "qvel")
    tp.assert_close(td.qacc, d.qacc, 5e-3, 5e-3, "qacc")
