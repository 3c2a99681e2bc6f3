"""Kernel C's plain version (vnl_tpu_torch/ops/sweep.py inv_spd_sweep_plain,
which a CPU tensor takes) against the Pallas sweep of vnl_tpu in interpret
mode and against float64 numpy, and refine_inv against vnl_tpu's.

Tolerances: 2e-5 of the inverse's largest entry, as
tests/test_pallas_ops.py holds the TPU kernel to numpy; the twin's mass
matrices (condition number ~1e5 before scaling) are held to the residual
|A X - I| < 5e-3 of tests/test_pallas_position.py:48-60; refine_inv is a
handful of fp32 products on both sides, 1e-5 of the largest entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu.ops import linalg as jlinalg
from vnl_tpu.ops.pallas_linalg import inv_spd_lanes
from vnl_tpu_torch.ops import launch_counts
from vnl_tpu_torch.ops import linalg as tlinalg
from vnl_tpu_torch.ops import sweep
from vnl_tpu_torch.physics import forward as tfwd
from vnl_tpu_torch.physics import inertia as tinertia
from vnl_tpu_torch.physics import kinematics as tkin

import torch_parity as tp


def _spd_batch(rng, b, n):
    """tests/test_pallas_ops.py:10 _spd_batch."""
    scale = rng.uniform(0.05, 2.0, (b, 1, n)).astype(np.float32)
    L = rng.normal(size=(b, n, n)).astype(np.float32) * scale
    a = L @ np.transpose(L, (0, 2, 1)) + 0.5 * np.eye(n, dtype=np.float32)
    return (a + np.transpose(a, (0, 2, 1))) / 2


def _scaled(x, scale):
    return np.asarray(x, np.float64) / scale


def test_sweep_plain_matches_pallas_and_numpy():
    a = _spd_batch(np.random.default_rng(0), 12, 29)
    before = launch_counts["sweep"]
    got = sweep.inv_spd_sweep(torch.as_tensor(a)).numpy()
    assert launch_counts["sweep"] == before      # CPU: no kernel launch
    pallas = inv_spd_lanes(jnp.asarray(a), block=4, interpret=True)
    want = np.linalg.inv(a.astype(np.float64))
    scale = np.abs(want).max()
    np.testing.assert_allclose(_scaled(got, scale), want / scale, atol=2e-5)
    np.testing.assert_allclose(_scaled(got, scale), _scaled(pallas, scale),
                               atol=2e-5)
    np.testing.assert_array_equal(got, np.transpose(got, (0, 2, 1)))


@pytest.mark.parametrize("layout", ["pair_first", "batch_first"])
def test_sweep_plain_stacked_pair(layout):
    """The stacked pair of inertia.crb, (2, B, n, n) or (B, 2, n, n): the
    leading dims are flattened and restored."""
    a = _spd_batch(np.random.default_rng(1), 6, 17)
    pair = np.stack([a, 2.0 * a], axis=0 if layout == "pair_first" else 1)
    got = sweep.inv_spd_fused(torch.as_tensor(pair)).numpy()
    assert got.shape == pair.shape
    want = np.linalg.inv(a.astype(np.float64))
    scale = np.abs(want).max()
    first, second = ((got[0], got[1]) if layout == "pair_first"
                     else (got[:, 0], got[:, 1]))
    np.testing.assert_allclose(_scaled(first, scale), want / scale,
                               atol=2e-5)
    np.testing.assert_allclose(_scaled(second, scale), want / 2 / scale,
                               atol=2e-5)


def _twin_pair(batch=3):
    """[qM, qM + h diag(B)] of the twin at perturbed states: (2, B, 73, 73)."""
    tm = tp.torch_model(tp.jax_twin())
    qpos, _ = tp.perturbed_states(tp.jax_twin(), batch, seed=3)
    d = tfwd.make_data(tm, batch, qpos=torch.as_tensor(qpos))
    d = tkin.com_pos(tm, tkin.kinematics(tm, d))
    qM = tinertia.assemble_qM(tm, d)
    hB = tm.opt.timestep * tm.dof_damping
    return torch.stack([qM, qM + torch.diag(hB)])


def test_sweep_plain_inverts_twin_mass_matrices():
    pair = _twin_pair()
    assert pair.shape[-1] == 73
    inv = sweep.inv_spd_sweep(pair)
    resid = (pair @ inv - torch.eye(73)).abs().max()
    assert float(resid) < 5e-3, float(resid)
    want = np.linalg.inv(pair.numpy().astype(np.float64))
    for k in range(2):
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(inv[k].numpy(), want[k], rtol=5e-3,
                                   atol=1e-4 * scale)


def test_sweep_rejects_bad_inputs():
    good = torch.eye(4).expand(3, 4, 4).contiguous()
    for bad in (good.double(), torch.zeros(3, 4, 5), torch.zeros(4),
                good.transpose(1, 2)[:, :, ::2]):
        with pytest.raises(ValueError):
            sweep.inv_spd_sweep(bad)


def test_refine_inv_matches_jax():
    """A seed a percent off the inverse, two Newton-Schulz steps."""
    rng = np.random.default_rng(2)
    a = _spd_batch(rng, 5, 17)
    x0 = np.linalg.inv(a.astype(np.float64))
    x0 = (x0 * (1.0 + 0.01 * rng.normal(size=x0.shape))).astype(np.float32)
    want = np.asarray(jlinalg.refine_inv(jnp.asarray(a), jnp.asarray(x0)))
    got = tlinalg.refine_inv(torch.as_tensor(a), torch.as_tensor(x0)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-5)
    exact = np.linalg.inv(a.astype(np.float64))
    assert np.abs(got - exact).max() < np.abs(x0 - exact).max()
