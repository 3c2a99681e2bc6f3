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
    """The static tables kernel A walks: pointer doubling over body_parent
    reaches the world frame from every body within nrounds rounds (and not
    within one fewer), and the (dof, ancestor) pairs reproduce the model's
    dof ancestry."""
    tm = tp.torch_model(tp.jax_twin())
    t = tpos.kernel_tables(tm)
    parent = np.asarray(t["ints"]["body_parent"]).copy()
    parent[0] = 0
    assert np.all(parent[1:] < np.arange(1, tm.nbody))
    anc, left = parent.copy(), []
    for _ in range(t["nrounds"]):
        left.append(int((anc != 0).sum()))
        anc = anc[anc]
    assert np.all(anc == 0) and left[-1] > 0
    assert t["depth"].max() == 35 and t["nrounds"] == 6
    pair = t["ints"]["anc_pair"]
    assert len(set(pair.tolist())) == len(pair)
    anc = np.zeros((tm.nv, tm.nv), bool)
    anc[pair >> 16, pair & 0xffff] = True
    np.testing.assert_array_equal(anc, np.asarray(tm.dof_ancestor_mask))


@pytest.mark.parametrize("scene", ["twin", "box_chain"])
def test_subtree_lists_reproduce_subtree_sums(scene):
    """Summing each body's descendant list (what kernel A does for subtree
    com and the composite inertias) gives body_subtree_mask @ values, and
    every list starts with the body itself and ascends."""
    jm = {"twin": tp.jax_twin, "box_chain": tp.jax_box_chain}[scene]()
    tm = tp.torch_model(jm)
    ints = tpos.kernel_tables(tm)["ints"]
    start, body = ints["sub_start"], ints["sub_body"]
    assert len(start) == tm.nbody + 1 and start[-1] == len(body)
    vals = np.random.default_rng(0).normal(size=(tm.nbody, 5))
    got = np.stack([vals[body[start[b]:start[b + 1]]].sum(0)
                    for b in range(tm.nbody)])
    want = np.asarray(tm.body_subtree_mask, np.float64) @ vals
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for b in range(tm.nbody):
        own = body[start[b]:start[b + 1]]
        assert own[0] == b and np.all(np.diff(own) > 0)


@pytest.mark.parametrize("nv", [1, 7, 29, 73, 96])
def test_tile_map_covers_matrix_once(nv):
    """Every (row, column) of an nv x nv matrix lies in exactly one
    thread's register tile, and the tile chosen is an instantiated one."""
    tr, tc = tpos.tile_shape(nv)
    assert (tr, tc) in tpos.TILE_SHAPES
    rs = tpos.tile_map(nv, tr, tc)
    assert rs.shape == (32 * tpos.tile_warps(tr, tc), tr * tc, 2)
    inside = rs[(rs >= 0).all(-1)]
    hits = np.zeros((nv, nv), int)
    np.add.at(hits, (inside[:, 0], inside[:, 1]), 1)
    assert np.all(hits == 1)
    assert np.all(rs[(rs < 0).any(-1)] == -1)


def test_tile_shape_rejects_wider_matrices():
    widest = max(min(tpos.tile_warps(tr, tc) * tr, 32 * tc)
                 for tr, tc in tpos.TILE_SHAPES)
    assert widest >= 96
    with pytest.raises(ValueError):
        tpos.tile_shape(widest + 1)


@pytest.mark.parametrize("nv,tile", [(1, (16, 1)), (8, (16, 1)),
                                     (14, (16, 1)), (16, (16, 1)),
                                     (27, (32, 1)), (32, (32, 1)),
                                     (33, (10, 3)), (73, (10, 3))])
def test_tile_shape_picks_the_warp_route(nv, tile):
    """Up to nv 32 one warp sweeps a matrix (the humanoid's 27, the ant's
    14, the small scenes' 7); from 33 on, the twin's tile of 8 warps."""
    assert tpos.tile_shape(nv) == tile
    assert (tpos.tile_warps(*tile) == 1) == (nv <= 32)


def test_source_instantiates_tile_shapes():
    """The kernel source instantiates exactly TILE_SHAPES: TILE(TR, TC)
    for the tiles of WARPS warps, WARP_TILE(T) for the one-warp route
    (TC = 1), and its kWarps is WARPS."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tpos.__file__), os.pardir,
                            "csrc", "position.cu")).read()
    tiles = [tuple(map(int, t)) for t in
             re.findall(r"^  TILE\((\d+), (\d+)\)$", src, re.M)]
    warp = [(int(t), 1) for t in re.findall(r"^  WARP_TILE\((\d+)\)$", src,
                                            re.M)]
    assert tuple(warp + tiles) == tpos.TILE_SHAPES
    assert tuple(warp) == tpos.WARP_TILES
    assert int(re.search(r"constexpr int kWarps = (\d+);", src).group(1)) \
        == tpos.WARPS


def _warp_sweep(a, T):
    """The one-warp route's sweep in numpy float32, lane by lane: lane s
    holds column s of the Jacobi-scaled matrix in T registers (zeros
    beyond nv); pivot k takes column k from lane k and row k from each
    lane's own register k."""
    nv = a.shape[0]
    s = (1.0 / np.sqrt(np.diag(a))).astype(np.float32)
    reg = np.zeros((32, T), np.float32)                 # reg[lane, row]
    reg[:nv, :nv] = (a * s[:, None] * s[None, :]).T
    lanes = np.arange(32)
    for k in range(nv):
        dinv = np.float32(1.0) / reg[k, k]
        w = (reg[:, k] - (lanes == k)).astype(np.float32) * dinv
        v = reg[k].copy()
        v[k] -= np.float32(1.0)
        reg -= w[:, None] * v[None, :]
        reg[k, k] -= np.float32(2.0)
    return -reg[:nv, :nv].T * s[:, None] * s[None, :]


@pytest.mark.parametrize("scene", ["humanoid", "ant", "box_chain"])
def test_warp_sweep_inverts_mass_matrices(scene):
    """The one-warp route's arithmetic (numpy, float32) inverts qM and
    qM + h diag(B) of the humanoid (nv 27, 32 rows a lane), the ant (14,
    16) and the box chain (7, 16) at kernel A's tolerances: rtol 5e-3,
    atol 1e-4 * scale against the float64 inverse and |A X - I| < 5e-3."""
    from vnl_tpu_torch import compat, kernel_bench
    from vnl_tpu_torch.physics import inertia
    if scene == "box_chain":
        m = compat.model_from_numpy(compat.BOX_CHAIN_MODEL, device="cpu")
    else:
        m = kernel_bench.scene(scene, device="cpu")[0]
    T = tpos.tile_shape(m.nv)[0]
    assert (T, 1) in tpos.WARP_TILES
    qpos = kernel_bench.random_states(m, 3, torch.Generator().manual_seed(4))
    qM = tpos.position_plain(m, qpos)[11].double().numpy()
    hB = np.diag(m.opt.timestep * m.dof_damping.double().numpy())
    assert inertia.needs_implicit_damping(m)
    for A in np.concatenate([qM, qM + hB]):
        got = _warp_sweep(A.astype(np.float32), T).astype(np.float64)
        want = np.linalg.inv(A)
        np.testing.assert_allclose(got, want, rtol=5e-3,
                                   atol=1e-4 * np.abs(want).max())
        assert np.abs(A @ got - np.eye(m.nv)).max() < 5e-3
