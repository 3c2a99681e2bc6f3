"""The seam between the physics stages and the hand-written kernels, read
from the sources with ``ast``: ops/ sits above physics/, which reaches
down into ops/ only for the Model-free linalg and sweep, but for
forward.py, the one caller of the Model-bound kernels; no import of ops/
or physics/ hides inside a function; each kernel chooses between itself
and its plain version in one function; and every kernel source has one
entry in the ``ops.KERNELS`` registry, from which the build, the
profiling tools and chip_smoke.py take the tables they held before.

Kernel F's side on the CPU (the kernel itself against the plain loop is
tests/test_torch_gae_kernel.py, on the card): CPU tensors take the plain
loop and launch nothing, the loss gives the bits of the plain loss frozen
under benchmark/reference/plain, its GAE is the tagged part ``gae``, and
the strides the wrapper passes reach every element of its inputs."""

import ast
import ctypes
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from benchmark.reference.plain.training import losses as frozen_losses
from vnl_tpu_torch import models, profile_rollout
from vnl_tpu_torch.ops import KERNELS, build, launch_counts
from vnl_tpu_torch.ops import gae as gae_ops
from vnl_tpu_torch.training import Transition, losses
from vnl_tpu_torch.utils import profiler

PKG = os.path.dirname(os.path.dirname(build.__file__))


def _modules(sub=""):
    top = os.path.join(PKG, sub)
    for d, _, files in os.walk(top):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    yield os.path.relpath(path, PKG), ast.parse(fh.read())


def _imported(node):
    """The dotted names an import statement brings in."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.module:
        return [f"{node.module}.{a.name}" for a in node.names]
    return []


def _of_ops_or_physics(name):
    return name.startswith(("vnl_tpu_torch.ops", "vnl_tpu_torch.physics"))


def test_no_function_imports_ops_or_physics():
    found = []
    for path, tree in _modules():
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                found += [(path, fn.name, n) for node in ast.walk(fn)
                          for n in _imported(node) if _of_ops_or_physics(n)]
    assert found == []


def test_physics_reaches_only_linalg_and_sweep_but_forward():
    allowed = ("vnl_tpu_torch.ops.linalg", "vnl_tpu_torch.ops.sweep")
    found = []
    for path, tree in _modules("physics"):
        if path == os.path.join("physics", "forward.py"):
            continue
        found += [(path, n) for node in ast.walk(tree)
                  for n in _imported(node)
                  if n.startswith("vnl_tpu_torch.ops")
                  and not n.startswith(allowed)]
    assert found == []
    forward = dict(_modules("physics"))[os.path.join("physics",
                                                     "forward.py")]
    assert {n for node in ast.walk(forward) for n in _imported(node)
            if n.startswith("vnl_tpu_torch.ops.")} >= {
        f"vnl_tpu_torch.ops.{k}" for k in ("position", "collision",
                                           "constraints", "cg")}


@pytest.mark.parametrize("module,chooser", [
    ("position", "position"), ("cg", "solve"), ("sweep", "inv_spd_sweep"),
    ("constraints", "takes_kernel"), ("collision", "collide"),
    ("gae", "compute_gae")])
def test_each_kernel_chooses_its_route_in_one_function(module, chooser):
    """``is_cuda`` is read by one function of the kernel's module, and by
    no module of physics/."""
    tree = dict(_modules("ops"))[os.path.join("ops", f"{module}.py")]
    readers = {fn.name for fn in ast.walk(tree)
               if isinstance(fn, ast.FunctionDef)
               for node in ast.walk(fn)
               if isinstance(node, ast.Attribute) and node.attr == "is_cuda"}
    assert readers == {chooser}
    for path, tree in _modules("physics"):
        assert not any(isinstance(node, ast.Attribute)
                       and node.attr == "is_cuda"
                       for node in ast.walk(tree)), path


def test_registry_names_every_source_once():
    sources = sorted(f for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    assert sorted(k.source for k in KERNELS.values()) == sources
    assert [k.name for k in KERNELS.values()] == [
        "position", "cg", "sweep", "constraints", "collision", "gae"]
    assert [k.letter for k in KERNELS.values()] == list("ABCDEF")


def test_tables_from_the_registry_are_the_former_literals():
    """The build's flags (and so every library's name), the profiling
    tools' kernel groups and parts, and chip_smoke's counters."""
    assert build.FLAGS == {"collision": ("-fmad=false",),
                           "gae": ("-fmad=false",)}
    assert [(g, p.pattern) for g, p in profile_rollout.KERNEL_GROUPS] == [
        (group, rf"(?<![a-z_]){names}_kernel(?![a-z_])")
        for group, names in (("kernel A (position)", "position(_warp)?"),
                             ("kernel B (cg)", "cg(_wide)?"),
                             ("kernel C (sweep)", "sweep(_tile|_warp)?"),
                             ("kernel D (constraints)", "constraints"),
                             ("kernel E (collision)", "collision"),
                             ("kernel F (gae)", "gae"))]
    assert profile_rollout.KERNEL_PARTS == {
        "kernel A (position)": "position", "kernel B (cg)": "solve",
        "kernel D (constraints)": "constraints",
        "kernel E (collision)": "collision", "kernel F (gae)": "gae"}
    assert chip_smoke.COUNTED_GROUPS == (
        ("position", "kernel A (position)"), ("cg", "kernel B (cg)"),
        ("sweep", "kernel C (sweep)"),
        ("constraints", "kernel D (constraints)"),
        ("collision", "kernel E (collision)"), ("gae", "kernel F (gae)"))


# ---- kernel F on the CPU ----

def test_kernel_f_entry():
    """GAE's kernel: letter F, its own source, part ``gae`` of the
    SGD-update graph, each operation rounded on its own."""
    k = KERNELS["gae"]
    assert (k.letter, k.source, k.part, k.flags) == (
        "F", "gae.cu", "gae", ("-fmad=false",))
    assert k.label == "kernel F (gae)"


def _gae_inputs(T, B, seed):
    """Time-major [T, B] views of [B, T] buffers, as the loss hands them
    over, and a bootstrap value; some steps truncated, some terminated."""
    gen = torch.Generator().manual_seed(seed)
    done = torch.rand(B, T, generator=gen) < 0.3
    cut = torch.rand(B, T, generator=gen) < 0.5
    rows = [(done & cut).float(), (done & ~cut).float(),
            torch.rand(B, T, generator=gen), torch.randn(B, T, generator=gen)]
    return [x.transpose(0, 1) for x in rows] + [torch.randn(B, generator=gen)]


@pytest.mark.parametrize("lambda_,discount", [(0.95, 0.9), (1.0, 0.99)])
def test_gae_choice_takes_the_plain_loop_on_the_cpu(lambda_, discount):
    x = _gae_inputs(20, 6, seed=1)
    before = dict(launch_counts)
    got = losses.compute_gae(*x, lambda_=lambda_, discount=discount)
    assert dict(launch_counts) == before
    assert losses.compute_gae is gae_ops.compute_gae
    want = gae_ops.compute_gae_plain(*x, lambda_=lambda_, discount=discount)
    for g, w in zip(got, want):
        assert g.shape == (20, 6) and torch.equal(g, w)


def test_gae_kernel_inputs_reach_every_element():
    """Each input's address and element strides, as the kernel reads
    them, give back the tensor, for time-major views, slices and a strided
    bootstrap value; the structs are laid out as the source's."""
    x = _gae_inputs(5, 7, seed=2)
    x = [t[1:, 2:] for t in x[:4]] + [torch.randn(9, 2)[4:, 1]]
    ins = gae_ops.kernel_inputs(*x)
    assert ctypes.sizeof(gae_ops.Seq) == 24
    assert ctypes.sizeof(gae_ops.GaeIn) == 4 * 24 + 16

    def read(t, p, strides, shape):
        base = t.untyped_storage().data_ptr()
        flat = torch.empty(0).set_(t.untyped_storage())
        return flat.as_strided(shape, strides, (p - base) // 4)

    for name, t in zip(gae_ops.SEQ_NAMES, x):
        seq = getattr(ins, name)
        assert torch.equal(read(t, seq.p, (seq.st, seq.sb), (4, 5)), t)
    assert torch.equal(read(x[4], ins.bootstrap, (ins.bootstrap_sb,), (5,)),
                       x[4])


def _loss_inputs(seed, B=6, T=20, traj=10, obs=7, act=3, latent=4):
    """A small intention network and a minibatch with its noise."""
    gen = torch.Generator().manual_seed(seed)
    net = models.make_intention_ppo_networks(
        traj, obs, act, intention_latent_size=latent,
        encoder_layer_sizes=(16,), decoder_layer_sizes=(16,),
        value_hidden_layer_sizes=(16,), generator=gen, device="cpu")
    trunc, term, reward, _, _ = _gae_inputs(T, B, seed)
    data = Transition(
        observation=torch.randn(B, T, obs, generator=gen),
        action=torch.rand(B, T, act, generator=gen) * 2 - 1,
        reward=reward.t(), discount=1.0 - term.t(),
        next_observation=torch.randn(B, T, obs, generator=gen),
        extras={"policy_extras": {
                    "raw_action": torch.randn(B, T, act, generator=gen),
                    "log_prob": torch.randn(B, T, generator=gen) - 3.0},
                "state_extras": {
                    "truncation": trunc.t(),
                    "traj": torch.randn(B, T, traj, generator=gen)}})
    noise = dict(latent_noise=torch.randn(T, B, latent, generator=gen),
                 entropy_noise=torch.randn(T, B, act, generator=gen))
    return net, data, noise


def test_loss_on_the_cpu_is_the_frozen_plain_loss():
    """The loss, its metrics and its gradients equal, bit for bit, those of
    the plain loss as it stood before kernel F (the frozen copy)."""
    kw = dict(discounting=0.9, gae_lambda=0.95, entropy_cost=1e-2,
              reward_scaling=2.0, kl_weight=1e-2)
    out = []
    for loss_fn in (losses.compute_ppo_intention_loss,
                    frozen_losses.compute_ppo_intention_loss):
        net, data, noise = _loss_inputs(3)
        total, metrics = loss_fn(net, data, **noise, **kw)
        total.backward()
        out.append((total.detach(), metrics,
                    [p.grad for p in net.parameters()]))
    (t0, m0, g0), (t1, m1, g1) = out
    assert torch.equal(t0, t1)
    assert sorted(m0) == sorted(m1) and all(torch.equal(m0[k], m1[k])
                                            for k in m0)
    assert len(g0) == len(g1) and all(torch.equal(a, b)
                                      for a, b in zip(g0, g1))


class _OpCount(TorchDispatchMode):
    """Counts the operations dispatched, views left out."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


def test_loss_tags_its_gae_as_part_gae():
    """Inside a ``parts_counted`` block (a capture's, on the card) the
    loss's GAE is part ``gae``: on the CPU, the plain loop's operations at
    T = 20, 7 a step and 11 around the loop (its set-up, two stacks and
    the targets' sum); the rest of the loss outside every part."""
    net, data, noise = _loss_inputs(4)
    with torch.no_grad(), _OpCount() as ops, \
            profiler.parts_counted(lambda: ops.n) as parts:
        losses.compute_ppo_intention_loss(net, data, **noise)
    assert set(parts.counts) == {"gae"}
    assert parts.counts["gae"] == 7 * 20 + 11
    assert parts.outside > 0
