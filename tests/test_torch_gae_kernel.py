"""Kernel F (ops/gae.py, csrc/gae.cu), GAE's reverse loop over an unroll
in one launch, against the plain loop (ops/gae.py compute_gae_plain) on a
CUDA device (marked ``cuda``; skipped without a card, since a CUDA kernel
has no CPU mode).  Imports neither JAX nor vnl_tpu, so it also runs where
only the port is installed:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gae_kernel.py -m cuda

The kernel rounds each operation on its own, as the plain loop's separate
PyTorch operations do, so its targets and advantages must equal the plain
loop's bit for bit, on the card and on the CPU.  The inputs are what the
loss hands over: time-major views of [B, T] buffers, with random
truncations and terminations.  The CPU side (the registry entry, the
choice, the strides the wrapper passes) is in tests/test_torch_ops.py."""

import functools

import pytest
import torch

from vnl_tpu_torch.ops import gae as gae_ops
from vnl_tpu_torch.ops import launch_counts

# the training cells' minibatch, the bench's, a ragged block, one step
SHAPES = [(20, 32), (20, 1024), (20, 33), (1, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return "cuda"


def gae_inputs(T, B, seed, device):
    """(truncation, termination, rewards, values, bootstrap_value): the
    first four time-major [T, B] views of [B, T] buffers, a quarter of the
    steps done, half of those truncated and the rest terminated."""
    gen = torch.Generator().manual_seed(seed)
    done = torch.rand(B, T, generator=gen) < 0.25
    cut = torch.rand(B, T, generator=gen) < 0.5
    rows = [(done & cut).float(), (done & ~cut).float(),
            torch.rand(B, T, generator=gen),
            torch.randn(B, T, generator=gen)]
    boot = torch.randn(B, generator=gen)
    return tuple(x.to(device).transpose(0, 1) for x in rows) + (
        boot.to(device),)


@pytest.mark.cuda
@pytest.mark.parametrize("lambda_,discount", [(0.95, 0.9), (1.0, 0.99)])
@pytest.mark.parametrize("T,B", SHAPES)
def test_gae_kernel_equals_the_plain_loop(cuda, T, B, lambda_, discount):
    x = gae_inputs(T, B, seed=T * B, device=cuda)
    assert not x[3].is_contiguous() or T == 1
    before = launch_counts["gae"]
    got = gae_ops.compute_gae(*x, lambda_=lambda_, discount=discount)
    assert launch_counts["gae"] == before + 1
    on_card = gae_ops.compute_gae_plain(*x, lambda_=lambda_,
                                        discount=discount)
    on_cpu = gae_ops.compute_gae_plain(*(t.cpu() for t in x),
                                       lambda_=lambda_, discount=discount)
    for g, w, c in zip(got, on_card, on_cpu):
        assert g.shape == (T, B) and g.dtype == torch.float32
        assert g.is_contiguous()
        assert torch.equal(g, w)
        assert torch.equal(g.cpu(), c)


@pytest.mark.cuda
def test_gae_kernel_reads_any_strides(cuda):
    """Contiguous [T, B] inputs, a strided bootstrap and a column slice
    give the plain loop's bits too."""
    x = [t.contiguous() for t in gae_inputs(20, 40, seed=3, device=cuda)]
    boot = torch.randn(40, 3, device=cuda)[:, 1]
    cols = [t[:, 5:37] for t in x[:4]]
    for args in (x[:4] + [boot], cols + [x[4][5:37]]):
        got = gae_ops.compute_gae(*args, lambda_=0.95, discount=0.9)
        want = gae_ops.compute_gae_plain(*args, lambda_=0.95, discount=0.9)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_gae_kernel_rejects_bad_inputs(cuda):
    """Another dtype, shape or device is refused, naming the input (the
    batch is the bootstrap value's length; the values on the CPU choose
    the plain loop)."""
    x = list(gae_inputs(20, 32, seed=1, device=cuda))
    for i, name in enumerate(gae_ops.SEQ_NAMES + ("bootstrap_value",)):
        bad = ([x[i].double()] + ([x[i].cpu()] if name != "values" else [])
               + ([x[i][:, :16]] if i < 4 else []))
        for b in bad:
            with pytest.raises(ValueError, match=name):
                gae_ops.compute_gae(*x[:i], b, *x[i + 1:])


@pytest.mark.cuda
def test_gae_kernel_resources(cuda):
    """One block of 128 threads a 128 columns, nothing spilled."""
    res = gae_ops.resources()
    assert res["regs"] > 0 and res["blocks_per_sm"] > 0
    assert res["local_bytes"] == 0 and res["threads"] == 128


@pytest.mark.cuda
def test_gae_is_one_node_of_the_sgd_update_graph(cuda):
    """The loss's GAE in the SGD-update graph: its ``gae`` part one node,
    one kernel F launch a replay, the eager update's numbers bit for
    bit."""
    from vnl_tpu_torch import models
    from vnl_tpu_torch.training import (Transition, compute_ppo_intention_loss,
                                        gradients)
    from vnl_tpu_torch.utils import graphs
    traj, obs, act, B, T = 12, 7, 3, 32, 20
    gen = torch.Generator().manual_seed(4)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(cuda)

    trunc, term, *_ = gae_inputs(T, B, seed=5, device=cuda)
    batch = Transition(
        observation=rand(B, T, obs), action=rand(B, T, act).tanh(),
        reward=rand(B, T), discount=1.0 - term.t(),
        next_observation=rand(B, T, obs),
        extras={"policy_extras": {"raw_action": rand(B, T, act),
                                  "log_prob": rand(B, T) - 3.0},
                "state_extras": {"truncation": trunc.t().contiguous(),
                                 "traj": rand(B, T, traj)}})
    runs = []
    for graphed in (False, True):
        net = models.make_intention_ppo_networks(
            traj, obs, act, intention_latent_size=4,
            encoder_layer_sizes=(16,), decoder_layer_sizes=(16,),
            value_hidden_layer_sizes=(16,),
            generator=torch.Generator().manual_seed(6), device=cuda)
        loss_gen = torch.Generator(device=cuda).manual_seed(7)
        update = gradients.gradient_update_fn(
            functools.partial(compute_ppo_intention_loss, net,
                              generator=loss_gen),
            gradients.make_adam(net.parameters(), 1e-3), has_aux=True,
            cuda_graph=graphed, generators=(loss_gen,))
        launch_counts.clear()
        out = [update(batch) for _ in range(3)]
        assert launch_counts["gae"] == 3
        runs.append([(loss.detach(), stats) for loss, stats in out])
        if graphed:
            report = graphs.REPORTS[-1]
            assert report["name"] == "sgd_update"
            assert report["parts"] == {"gae": 1}
            assert report["launches_per_replay"] == {"gae": 1}
    for (le, se), (lg, sg) in zip(*runs):
        assert torch.equal(le, lg)
        assert sorted(se) == sorted(sg)
        assert all(torch.equal(se[k], sg[k]) for k in se)
