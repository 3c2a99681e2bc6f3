"""Kernels A and B against their plain PyTorch versions on a CUDA device
(marked ``cuda``; skipped without a card, since a CUDA kernel has no CPU
mode).  Imports neither JAX nor vnl_tpu, so it also runs where only the
port is installed:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import pytest
import torch

from vnl_tpu_torch import compat
from vnl_tpu_torch.ops import cg as cg_ops
from vnl_tpu_torch.ops import launch_counts
from vnl_tpu_torch.ops import position as pos_ops
from vnl_tpu_torch.physics import actuation, forward, inertia, solver

B = 64


@pytest.fixture
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return compat.model_from_numpy(compat.TWIN_MODEL, device="cuda")


def _states(m, press=0.0):
    gen = torch.Generator(device="cuda").manual_seed(0)
    qpos = m.qpos0.expand(B, -1).clone()
    qpos[:, 2] -= press
    lo, hi = m.jnt_range[1:, 0], m.jnt_range[1:, 1]
    qpos[:, 7:] = lo + torch.rand(B, m.nq - 7, generator=gen,
                                  device="cuda") * (hi - lo)
    qvel = 0.5 * torch.randn(B, m.nv, generator=gen, device="cuda")
    return qpos, qvel


def _close(got, want, rtol, atol, name):
    err = (got - want).abs()
    assert bool((err <= atol + rtol * want.abs()).all()), (
        name, float(err.max()))


@pytest.mark.cuda
def test_position_kernel_matches_plain(model):
    qpos, _ = _states(model)
    before = launch_counts["position"]
    got = pos_ops.position(model, qpos)
    assert launch_counts["position"] == before + 1
    want = pos_ops.position_plain(model, qpos)
    for name, g, w in zip(pos_ops.OUTPUT_NAMES[:12], got, want):
        _close(g, w, 2e-5, 2e-5, name)
    for name, g, w in zip(pos_ops.OUTPUT_NAMES[12:], got[12:], want[12:]):
        _close(g, w, 5e-3, 1e-4 * float(w.abs().max()), name)


@pytest.mark.cuda
def test_cg_kernel_matches_plain(model):
    qpos, qvel = _states(model, press=0.005)
    d = forward.make_data(model, B, qpos=qpos, qvel=qvel)
    d, efc = forward.fwd_position(model, d)
    d = forward.fwd_velocity(model, d)
    _, qfrc_act, _ = actuation.actuation(model, d)
    qacc_smooth = inertia.solve_m(d, d.qfrc_passive - d.qfrc_bias + qfrc_act)
    args, st = solver.cg_inputs(model, d, efc, qacc_smooth, 6)
    got = cg_ops.cg(*args, statics=st)
    want = cg_ops.cg_plain(*args, statics=st)
    for name, g, w in zip(("qacc", "qfrc_constraint", "con_f"), got, want):
        _close(g, w, 1e-3, 1e-3, name)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(model):
    with pytest.raises(ValueError):
        pos_ops.position(model, torch.zeros(4, model.nq, device="cuda",
                                            dtype=torch.float64))
    with pytest.raises(ValueError):
        pos_ops.position(model, torch.zeros(4, model.nq + 1, device="cuda"))
