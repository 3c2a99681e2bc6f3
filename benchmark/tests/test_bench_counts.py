"""The work counts and peaks of benchmark/counts against values worked
out by hand at small sizes, and against the scenes' shapes."""

from __future__ import annotations

import pytest
import torch

from benchmark.counts import kernels, networks, peaks, scene
from benchmark import spec

TINY = dict(nq=2, nv=1, nbody=2, njnt=1, ngeom=1, damped=0, ncon=1,
            nlimit=1, chain=3.0, iters=2, ls_iters=1)


def test_position_cost_by_hand():
    # out floats: bodies 2 x (3+4+9+3+3+36) = 116, joint 6, geom 12,
    # cdof 6, qM and qMinv 2: 142; qpos in: 2
    assert kernels.position_out_floats(TINY) == 142
    assert kernels.position_cost(TINY, 3) == (3 * 4 * 144, 3 * 2 * 1)
    damped = dict(TINY, damped=1, nv=2)
    # nv 2: cdof 12, three 2 x 2 matrices 12; two sweeps of 2 x 2^3
    assert kernels.position_out_floats(damped) == 116 + 6 + 12 + 12 + 12
    assert kernels.position_cost(damped, 1)[1] == 2 * 2 * 8


def test_cg_cost_by_hand():
    # inputs 2*1 + 7 + 46 + 3 = 58 floats, outputs 2 + 4
    nbytes, flops = kernels.cg_cost(TINY, 1)
    assert nbytes == 4 * 58 + 4 * 6
    # jx = 36 + 72 + 1, jtf = 72 + 36 + 12 + 1, ls = 30,
    # an iteration 4 + 109 + 121 + 30 + 10 = 274
    assert flops == 2 * 274 + 109 + 121 + 2


def test_network_flops_by_hand():
    net = dict(intention_latent_size=2, encoder_layer_sizes=[3],
               decoder_layer_sizes=[4], value_hidden_layer_sizes=[4])
    sizes = dict(traj_size=5, obs_size=6, action_size=1)
    # encoder 2*5*3 = 30, mean and logvar 2*2*3*2 = 24,
    # decoder 2*(8*4 + 4*2) = 80
    assert networks.policy_flops(net, sizes) == 134
    assert networks.value_flops(net, sizes) == 2 * (6 * 4 + 4 * 1)
    ppo = dict(batch_size=2, num_minibatches=2, unroll_length=3,
               num_updates_per_batch=2)
    # 12 samples: 12 rollout forwards, 2 passes x 12 x 3 x (134 + 56)
    assert networks.training_step_flops(net, sizes, ppo) == \
        12 * 134 + 2 * 12 * 3 * 190


def test_peaks_and_precision():
    assert peaks.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 67e12) == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 495e12, "tf32") == pytest.approx(1.0)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        assert peaks.precision(torch.float32) == "fp32"
        torch.backends.cuda.matmul.allow_tf32 = True
        assert peaks.precision(torch.float32) == "tf32"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert peaks.precision(torch.bfloat16) == "bf16"


def test_scene_shapes_and_the_bounds_chip_smoke_reported():
    twin = scene.shapes(spec.cell("twin_train").config)
    assert (twin["nq"], twin["nv"], twin["nbody"], twin["ncon"],
            twin["nlimit"], twin["damped"], twin["substeps"]) == \
        (74, 73, 65, 23, 67, 1, 5)
    # kernel A and B at 1024 twin envs: 0.0262 and 0.0155 ms, by bytes
    # (PERF.md's table of kernels)
    a = peaks.least_seconds(*kernels.position_cost(twin, 1024))
    b = peaks.least_seconds(*kernels.cg_cost(twin, 1024))
    assert round(a * 1e3, 4) == 0.0262
    assert round(b * 1e3, 4) == 0.0155


@pytest.mark.parametrize("name", ["twin_train"])
def test_configuration_sizes_are_the_reference_envs(name):
    from benchmark import loops
    cfg = spec.cell(name).config
    env = loops.resolve(cfg["reference"]["env"])(device="cpu",
                                                 **cfg["env_args"])
    state = env.reset(2, generator=torch.Generator().manual_seed(0))
    assert cfg["sizes"] == dict(traj_size=state.info["traj"].shape[-1],
                                obs_size=state.obs.shape[-1],
                                action_size=env.action_size)
