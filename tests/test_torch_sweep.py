"""Kernel C's plain version (vnl_tpu_torch/ops/sweep.py inv_spd_sweep_plain,
which a CPU tensor takes) and the two-pivot form its register route runs
(inv_spd_sweep_pairs_plain) against the Pallas sweep of vnl_tpu in
interpret mode and against float64 numpy, the kernel's route by n, and
refine_inv and inv_spd_ns against vnl_tpu's.

Tolerances: 2e-5 of the inverse's largest entry, as
tests/test_pallas_ops.py holds the TPU kernel to numpy; the twin's mass
matrices (condition number ~1e5 before scaling) are held to the residual
|A X - I| < 5e-3 of tests/test_pallas_position.py:48-60; refine_inv is a
handful of fp32 products on both sides, 1e-5 of the largest entry;
inv_spd_ns is 16 iterations of two fp32 products on both sides, in
another summation order, 1e-4 of the largest entry (the JAX package's
docstring puts the method's own error near 5e-7 relative on the
rodent's mass matrices)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnl_tpu.ops import linalg as jlinalg
from vnl_tpu.ops.pallas_linalg import inv_spd_lanes
from vnl_tpu_torch import kernel_bench
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


@pytest.mark.parametrize("n", [29, 30])
def test_sweep_pairs_plain_matches_pallas_and_numpy(n):
    """Two pivots a step, an odd n ending on a single pivot."""
    a = _spd_batch(np.random.default_rng(n), 12, n)
    got = sweep.inv_spd_sweep_pairs_plain(torch.as_tensor(a)).numpy()
    pallas = inv_spd_lanes(jnp.asarray(a), block=4, interpret=True)
    want = np.linalg.inv(a.astype(np.float64))
    scale = np.abs(want).max()
    np.testing.assert_allclose(_scaled(got, scale), want / scale, atol=2e-5)
    np.testing.assert_allclose(_scaled(got, scale), _scaled(pallas, scale),
                               atol=2e-5)
    np.testing.assert_array_equal(got, np.transpose(got, (0, 2, 1)))


def test_sweep_pairs_plain_inverts_twin_mass_matrices():
    pair = _twin_pair()
    got = sweep.inv_spd_sweep_pairs_plain(pair)
    one = sweep.inv_spd_sweep_plain(pair)
    assert float((pair @ got - torch.eye(73)).abs().max()) < 5e-3
    for k in range(2):
        scale = float(one[k].abs().max())
        np.testing.assert_allclose(got[k].numpy(), one[k].numpy(), rtol=5e-3,
                                   atol=1e-4 * scale)


@pytest.mark.parametrize("n,kind,tile", [
    (1, "warp", (16, 1)), (2, "warp", (16, 1)),
    (8, "warp", (16, 1)), (16, "warp", (16, 1)),
    (17, "warp", (32, 1)), (29, "warp", (32, 1)),
    (32, "warp", (32, 1)), (33, "register", (8, 2)),
    (64, "register", (8, 2)), (73, "register", (10, 3)),
    (80, "register", (10, 3)), (81, "register", (12, 3)),
    (96, "register", (12, 3)), (97, "shared", (0, 0)),
    (238, "shared", (0, 0))])
def test_sweep_route(n, kind, tile):
    """Up to n = 32 the one-warp route of the smallest T >= n; then the
    smallest register tile that covers n (8 warps: n <= 8 TR and
    n <= 32 TC; TR even, the pivots go in pairs), else the shared-memory
    route up to 238."""
    r = sweep.route(n)
    assert (r.kind, r.tile) == (kind, tile)
    tiles = sweep.TILE_SHAPES[len(sweep.WARP_TILES):]
    assert all(tr % 2 == 0 and tc > 1 for tr, tc in tiles)
    if kind == "warp":
        assert tile in sweep.WARP_TILES
        assert all(t < n for t, _ in sweep.WARP_TILES if t < tile[0])
    elif kind == "register":
        assert all(t < n for t, _ in sweep.WARP_TILES)
        smaller = [(tr, tc) for tr, tc in tiles
                   if tr * tc < tile[0] * tile[1]]
        assert all(8 * tr < n or 32 * tc < n for tr, tc in smaller)
    else:
        assert all(8 * tr < n or 32 * tc < n for tr, tc in tiles)


def test_source_instantiates_tile_shapes():
    """The kernel source instantiates exactly TILE_SHAPES: WARP_TILE(T) for
    the one-warp route (TC = 1), TILE(TR, TC) for the register tiles of
    WARPS warps; its kWarps is WARPS and its kWarpMats, the matrices a
    block of the one-warp route, is WARP_MATS."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(sweep.__file__), os.pardir,
                            "csrc", "sweep.cu")).read()
    tiles = [tuple(map(int, t)) for t in
             re.findall(r"^  TILE\((\d+), (\d+)\)$", src, re.M)]
    warp = [(int(t), 1) for t in re.findall(r"^  WARP_TILE\((\d+)\)$", src,
                                            re.M)]
    assert tuple(warp + tiles) == sweep.TILE_SHAPES
    assert tuple(warp) == sweep.WARP_TILES
    assert int(re.search(r"constexpr int kWarps = (\d+);", src).group(1)) \
        == sweep.WARPS
    assert int(re.search(r"constexpr int kWarpMats = (\d+);",
                         src).group(1)) == sweep.WARP_MATS


def test_warp_sweep_is_shared(tmp_path, monkeypatch):
    """Kernels A and C run the one pivot loop of csrc/warp_sweep.cuh and
    hold no copy of it, and a change to the header renames (so rebuilds)
    the library of every source."""
    import os
    import shutil
    from vnl_tpu_torch.ops import build
    loop = "__shfl_sync(0xffffffffu, x[r], k)"
    srcs = {f: open(os.path.join(build.CSRC, f)).read()
            for f in ("position.cu", "sweep.cu", "warp_sweep.cuh")}
    assert loop in srcs["warp_sweep.cuh"]
    for f in ("position.cu", "sweep.cu"):
        assert '#include "warp_sweep.cuh"' in srcs[f]
        assert "warp_sweep<T>(" in srcs[f] and loop not in srcs[f]
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    before = {n: build._target(n) for n in ("position", "sweep", "cg")}
    (csrc / "warp_sweep.cuh").write_text(srcs["warp_sweep.cuh"] + "\n")
    after = {n: build._target(n) for n in before}
    assert all(before[n] != after[n] for n in before)


@pytest.mark.parametrize("n", [14, 27])
def test_sweep_plain_matches_pallas_at_the_warp_widths(n):
    """The ant's n = 14 and the humanoid's 27, which the one-warp route
    sweeps on the card: the plain version against the Pallas sweep in
    interpret mode (as tests/test_pallas_ops.py runs it) and float64 numpy,
    at 2e-5 of the scale."""
    a = _spd_batch(np.random.default_rng(100 + n), 12, n)
    got = sweep.inv_spd_sweep(torch.as_tensor(a)).numpy()
    pallas = inv_spd_lanes(jnp.asarray(a), block=4, interpret=True)
    want = np.linalg.inv(a.astype(np.float64))
    scale = np.abs(want).max()
    np.testing.assert_allclose(_scaled(got, scale), _scaled(pallas, scale),
                               atol=2e-5)
    np.testing.assert_allclose(_scaled(got, scale), want / scale, atol=2e-5)
    np.testing.assert_array_equal(got, np.transpose(got, (0, 2, 1)))


@pytest.mark.parametrize("n", [0, 239, 300])
def test_sweep_route_rejects(n):
    with pytest.raises(ValueError):
        sweep.route(n)
    assert sweep.MAX_N == 238


@pytest.mark.parametrize("layout", ["pair_first", "batch_first"])
def test_sweep_plain_stacked_pair(layout):
    """The stacked pair of inertia.crb, (2, B, n, n) or (B, 2, n, n): the
    leading dims are flattened and restored."""
    a = _spd_batch(np.random.default_rng(1), 6, 17)
    pair = np.stack([a, 2.0 * a], axis=0 if layout == "pair_first" else 1)
    got = sweep.inv_spd_sweep(torch.as_tensor(pair)).numpy()
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


def _ant_hessians(batch=4):
    """The Hessians of the first Newton iteration at ant contact states
    (kernel C's input on the Newton path), on the CPU: (batch, 14, 14)."""
    m, kw = kernel_bench.scene("ant", device="cpu")
    H, active = kernel_bench.newton_hessians(
        m, batch, torch.Generator().manual_seed(4), kw["press"])
    assert H.shape == (batch, 14, 14) and active > 0
    return H


@pytest.mark.parametrize("scene", ["twin", "ant"])
def test_inv_spd_ns_matches_jax(scene):
    """The twin's [qM, qM + h diag(B)] (n 73) and the ant's Newton
    Hessians (n 14): the same matrices through both packages."""
    a = (_twin_pair() if scene == "twin" else _ant_hessians()).numpy()
    want = np.asarray(jlinalg.inv_spd_ns(jnp.asarray(a)))
    got = tlinalg.inv_spd_ns(torch.as_tensor(a)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)
    exact = np.linalg.inv(a.astype(np.float64))
    assert np.abs(got - exact).max() < 1e-3 * np.abs(exact).max()
