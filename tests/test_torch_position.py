"""Kernel A's plain version (vnl_tpu_torch.ops.position.position_plain)
against vnl_tpu's position stage: physics/forward.py:59 _position_reference
on the rodent twin and the box scene, and the Pallas kernel itself
(interpret mode) on the box scene.  Tolerances of
tests/test_pallas_position.py: outputs 2e-5; inverses rtol 5e-3 with atol
1e-4 * scale and |A X - I| < 5e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu_torch.ops import position as tpos

import torch_parity as tp

B = 4
NAMES = tpos.OUTPUT_NAMES


def _states(jm, seed):
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(jm.qpos0, np.float64), (B, 1))
    qpos[:, :3] += 0.05 * rng.normal(size=(B, 3))
    qpos[:, 7:] += 0.1 * rng.normal(size=(B, jm.nq - 7))
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.2 * rng.normal(size=(B, 4))
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    return qpos.astype(np.float32)


def _compare(jm, tm, outs_ref, outs_got):
    assert len(outs_got) == len(outs_ref)
    n = len(NAMES) - 2
    for name, r, g in zip(NAMES[:n], outs_ref, outs_got):
        tp.assert_close(g, r, 2e-5, 2e-5, name)
    qM = np.asarray(outs_got[11])
    hB = np.diag(jm.opt.timestep * np.asarray(jm.dof_damping))
    eye = np.eye(jm.nv)
    for name, r, g, A in zip(NAMES[n:], outs_ref[n:], outs_got[n:],
                             (qM, qM + hB)):
        r, g = np.asarray(r), g.numpy()
        scale = np.abs(r).max()
        np.testing.assert_allclose(g, r, rtol=5e-3, atol=1e-4 * scale,
                                   err_msg=name)
        resid = np.abs(np.einsum("bij,bjk->bik", A, g) - eye).max()
        assert resid < 5e-3, (name, resid)


@pytest.mark.parametrize("scene", ["twin", "box", "box_chain"])
def test_plain_matches_position_reference(scene):
    jm = {"twin": tp.jax_twin, "box": tp.jax_box,
          "box_chain": tp.jax_box_chain}[scene]()
    tm = tp.torch_model(jm)
    qpos = _states(jm, seed=2)
    ref_fn = tp.jax_module("vnl_tpu.physics.forward")._position_reference(jm)[1]
    outs_ref = jax.jit(jax.vmap(ref_fn))(jnp.asarray(qpos))
    outs_got = tpos.position(tm, torch.as_tensor(qpos))     # CPU -> plain
    _compare(jm, tm, outs_ref, outs_got)


def test_plain_matches_pallas_kernel_box():
    """The TPU kernel run in interpret mode on the box scene with a hinged
    child (small, so the interpreter stays fast; see torch_parity.BOX_CHAIN
    for why the child)."""
    jm = tp.jax_box_chain()
    tm = tp.torch_model(jm)
    qpos = _states(jm, seed=3)
    ppos = tp.jax_module("vnl_tpu.ops.pallas_position")
    ref_fn = tp.jax_module("vnl_tpu.physics.forward")._position_reference(jm)[1]
    fused = ppos.make_position_fused(jm, ref_fn, interpret=True)
    outs_pal = jax.jit(jax.vmap(fused))(jnp.asarray(qpos))
    outs_got = tpos.position_plain(tm, torch.as_tensor(qpos))
    _compare(jm, tm, outs_pal, outs_got)


def test_kernel_tables_describe_the_tree():
    """The static tables kernel A walks: tree levels cover every body once
    with parents on earlier levels, and the parent-dof chains reproduce
    the model's dof ancestry."""
    tm = tp.torch_model(tp.jax_twin())
    t = tpos.kernel_tables(tm)
    order, start = t["ints"]["level_body"], t["ints"]["level_start"]
    assert sorted(order) == list(range(1, tm.nbody))
    level = np.zeros(tm.nbody, int)
    for lv in range(t["nlevel"]):
        level[order[start[lv]:start[lv + 1]]] = lv + 1
    parent = np.asarray(tm.body_parentid)
    assert np.all(level[parent[1:]] == level[1:] - 1)
    dof_parent = t["ints"]["dof_parent"]
    anc = np.zeros((tm.nv, tm.nv), bool)
    for i in range(tm.nv):
        j = i
        while j >= 0:
            anc[i, j] = True
            j = dof_parent[j]
    np.testing.assert_array_equal(anc, np.asarray(tm.dof_ancestor_mask))
