"""The CUDA-graph machinery of vnl_tpu_torch on the CPU, where nothing is
captured and every loop runs eagerly.

(a) The port's own Adam (training/gradients.py, on torch._foreach_*)
against optax.adam on fixed gradients over five updates, parameters at
1e-6, across a resume (adam_state -> load_adam_state) after the third
that carries the step count on.
(b) The unroll as the graphs run it, against the unroll before graphs (a
list of actor_step transitions stacked at the end), bit for bit on the
CPU twin: generate_unroll's slot writes and the in-place control step
(envs.step_in_place on a static State, utils.graphs.copy_) behind an
ActorStepGraph whose CUDA graph is replaced by a stub that runs the
captured function on the static tensors; a rebound state (a fresh reset)
is copied in.
(c) gradient_update_fn with cuda_graph=True, its CUDA graph replaced by
the same stub (the static minibatch, the packed outputs), against the
eager update on the PPO loss, bit for bit over three updates.
(d) The launch-count bookkeeping of a captured graph (ops.ReplayCounts):
the capture's counts taken back, added once per replay.
(e) The nest copy's aliasing rules, and that a CUDA graph asked for on
CPU tensors raises (train, Graph, ActorStepGraph, the update, the
stepping bench, the Evaluator, the eval callback).
(f) The kernel groups of profile_rollout.device_groups, by which
chip_smoke.py phase 15 counts the kernels a traced replay ran: every
__global__ kernel of a csrc source, demangled or mangled, falls in its
source's group and in no other, and PyTorch's own kernels in none.
(g) The Evaluator's episodes and the eval callback's batch-1 episode
behind the same stub graph (allowed on the CPU), against their eager
loops, bit for bit: the Evaluator's metrics and final state over two
evaluations with the policy's weights changed in place between them,
with and without fixed draws (``noise=``, a static latent); the
callback's series over two calls from one reseeded generator, stopping
at done and with given latent and action draws, each step in its own row.

The same paths on the card, graphed against eager, are in
tests/test_torch_cuda.py (marked ``cuda``) and chip_smoke.py phase 15."""

import collections
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vnl_tpu_torch import bench, compat, profile_rollout
from vnl_tpu_torch.envs import (make_twin_env, step_in_place,
                                wrap_for_training)
from vnl_tpu_torch.models import make_inference_fn
from vnl_tpu_torch.ops import ReplayCounts, launch_counts
from vnl_tpu_torch.training import (ActorStepGraph, Transition, actor_step,
                                    acting, compute_ppo_intention_loss,
                                    generate_unroll, gradients, train)
from vnl_tpu_torch.utils import graphs

import test_torch_losses as tl

LR = 6e-4
B, T = 4, 2
EXTRA = ("truncation", "traj")


def _tensors(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.normal(size=(5, 3))).astype(np.float32),
            "b": (scale * rng.normal(size=(3,))).astype(np.float32)}


def test_adam_matches_optax_over_five_updates_and_a_resume():
    params = _tensors(0)
    grads = [_tensors(1 + k, scale=10.0 ** (k - 3)) for k in range(5)]
    grads[1]["b"][0] = 0.0
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt = optax.adam(optax.constant_schedule(LR))
    state = opt.init(jparams)

    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params.items()}
    topt = gradients.make_adam(tparams.values(), LR)
    assert topt.count.dtype == torch.float32 and topt.count.device == \
        tparams["w"].device
    for step, g in enumerate(grads):
        if step == 3:        # resume into new parameters and a new Adam
            saved = gradients.adam_state(topt, tparams)
            saved = dict(saved, **{k: {n: t.clone() for n, t in v.items()}
                                   for k, v in saved.items() if k != "step"})
            tparams = {k: torch.nn.Parameter(v.detach().clone())
                       for k, v in tparams.items()}
            topt = gradients.make_adam(tparams.values(), LR)
            gradients.load_adam_state(topt, tparams, saved)
            assert saved["step"] == 3 and float(topt.count) == 3.0
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, v in g.items():
            tparams[k].grad = torch.tensor(v)
        topt.step()
        for k in params:
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), np.asarray(jparams[k]),
                rtol=1e-6, atol=1e-6, err_msg=f"{k} after update {step}")
    assert int(np.asarray(state[0].count)) == 5 == float(topt.count)
    assert gradients.adam_state(topt, tparams)["step"] == 5


class StubGraph:
    """graphs.Graph without a device: the capture runs nothing; a replay
    runs the captured function on the static arguments and writes what
    it returns into the outputs of the first replay, as a graph's replays
    write into the tensors of its capture."""

    report = {}

    def __init__(self, fn, args, name, generators=()):
        self.fn, self.args, self.outputs = fn, tuple(args), None

    def replay(self):
        out = self.fn(*self.args)
        if self.outputs is None:
            self.outputs = graphs.clone(out)
        else:
            graphs.copy_(self.outputs, out)
        return self.outputs


@pytest.fixture
def stub_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "Graph", StubGraph)
    monkeypatch.setattr(graphs, "require_cuda", lambda x, what: None)
    monkeypatch.setattr(graphs, "warm_up", lambda fn, *a, **kw: fn(*a, **kw))


def _assert_bits_equal(got, want):
    got, want = list(graphs.named_leaves(got)), list(graphs.named_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


def _stacked_unroll(env, state, policy, gen, steps):
    """generate_unroll before the graphs: transitions stacked at the end."""
    transitions = []
    for _ in range(steps):
        state, tr = actor_step(env, state, policy, gen, EXTRA)
        transitions.append(tr)
    return state, acting.tree_map(lambda *xs: torch.stack(xs), *transitions)


@pytest.fixture(scope="module")
def twin():
    env = wrap_for_training(make_twin_env(
        device="cpu", fused_position=False,
        physics_steps_per_control_step=2), episode_length=4)
    policy = make_inference_fn(compat.policy_from_numpy(
        compat.KEEPER_POLICY, device="cpu"))(deterministic=False)
    return env, policy


def test_graphed_unroll_matches_the_stacked_unroll(twin, stub_graphs):
    """Episodes of 4 steps, so that the auto-reset restores states within
    the 2 + 2 + 2 steps."""
    env, policy = twin
    runs = []
    for kind in ("stacked", "graph"):
        gen = torch.Generator().manual_seed(7)
        first = env.reset(B, generator=gen)
        step = ActorStepGraph(env, policy, gen, EXTRA) \
            if kind == "graph" else None
        if kind == "stacked":
            unroll = functools.partial(_stacked_unroll, env, policy=policy,
                                       gen=gen, steps=T)
        else:
            unroll = functools.partial(generate_unroll, env, policy=policy,
                                       generator=gen, unroll_length=T,
                                       extra_fields=EXTRA, step=step)
        state, roll1 = unroll(first)
        if step is not None:
            assert state is step.state
        state, roll2 = unroll(state)
        # a rebound state: a fresh reset, copied into the static one
        state, roll3 = unroll(env.reset(B, generator=gen))
        runs.append((graphs.clone(state), roll1, roll2, roll3))
    _assert_bits_equal(runs[1], runs[0])
    assert runs[0][1].reward.shape == (T, B)
    assert bool(runs[0][2].discount.eq(0).any())      # an episode ended


def test_in_place_step_never_aliases_its_state(twin):
    env, policy = twin
    gen = torch.Generator().manual_seed(3)
    static = graphs.clone(env.reset(B, generator=gen))
    before = graphs.clone(static)
    tr = step_in_place(functools.partial(
        actor_step, env, policy=policy, generator=gen, extra_fields=EXTRA),
        static)
    _assert_bits_equal(tr.observation, before.obs)
    held = {t.untyped_storage().data_ptr() for t in graphs.leaves(static)
            if t.numel()}
    assert not any(t.untyped_storage().data_ptr() in held
                   for t in graphs.leaves(tr))
    _assert_bits_equal(static.obs, tr.next_observation)


def _ppo_update(seed, cuda_graph):
    policy, value, normalizer = tl.small_weights(seed)
    net, params, norm = tl.jax_side(policy, value, normalizer)
    tnet = tl.torch_side(policy, value, normalizer)
    batch = tl.as_transition(tl.make_batch(seed + 1, 8, 5, net, params,
                                           norm), Transition, torch.as_tensor)
    gen = torch.Generator().manual_seed(seed + 2)
    update = gradients.gradient_update_fn(
        functools.partial(compute_ppo_intention_loss, tnet, generator=gen,
                          **tl.LOSS_KW),
        gradients.make_adam(tnet.parameters(), LR), has_aux=True,
        cuda_graph=cuda_graph, generators=(gen,))
    out = []
    for k in range(3):
        minibatch = acting.tree_map(lambda x: x[2 * k:2 * k + 4], batch)
        loss, stats = update(minibatch)
        out.append((loss.detach(), stats))
    return out, dict(tnet.state_dict())


def test_static_minibatch_update_matches_eager(stub_graphs):
    eager, eager_params = _ppo_update(41, cuda_graph=False)
    graphed, graphed_params = _ppo_update(41, cuda_graph=True)
    _assert_bits_equal(graphed, eager)
    _assert_bits_equal(graphed_params, eager_params)
    assert sorted(graphed[2][1]) == sorted(eager[2][1])


def test_replay_counts_add_the_capture_once_per_replay():
    collectives = {"grad_all_reduce": 4}
    launch_counts.clear()
    launch_counts.update(cg=2)
    counts = ReplayCounts(launch_counts, collectives)
    with counts.record() as deltas:
        launch_counts["position"] += 5
        launch_counts["cg"] += 5
        collectives["grad_all_reduce"] += 1
    assert launch_counts == collections.Counter(cg=2)
    assert collectives == {"grad_all_reduce": 4}
    assert deltas == [collections.Counter(position=5, cg=5),
                      collections.Counter(grad_all_reduce=1)]
    for _ in range(3):
        counts.replayed()
    assert launch_counts == collections.Counter(position=15, cg=17)
    assert collectives == {"grad_all_reduce": 7}
    launch_counts.clear()


def test_copy_reads_every_source_before_it_writes():
    dst = graphs.clone({"a": torch.arange(3.0), "b": torch.arange(3.0) + 10,
                        "c": torch.zeros(2)})
    a, b = dst["a"].clone(), dst["b"].clone()
    graphs.copy_(dst, {"a": dst["b"], "b": dst["a"][None][0], "c": dst["c"]})
    assert torch.equal(dst["a"], b) and torch.equal(dst["b"], a)
    with pytest.raises(ValueError, match="structure"):
        graphs.copy_(dst, {"a": a, "b": b})
    with pytest.raises(ValueError, match="destination"):
        graphs.copy_(dst, {"a": a, "b": b, "c": torch.zeros(3)})


def test_cuda_graphs_on_the_cpu_raise(twin):
    env, policy = twin
    with pytest.raises(ValueError, match="cuda_graphs"):
        train(None, num_timesteps=1, episode_length=1, num_envs=2,
              batch_size=2, num_minibatches=1, device="cpu",
              cuda_graphs=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.Graph(lambda x: x + 1, (torch.zeros(2),), name="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ActorStepGraph(env, policy, gen)(env.reset(2, generator=gen))
    w = torch.nn.Parameter(torch.ones(2))
    update = gradients.gradient_update_fn(
        lambda x: (w * x).sum(), gradients.make_adam([w], LR),
        cuda_graph=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        update(torch.ones(2))
    with pytest.raises(ValueError, match="CUDA device"):
        bench.run_stepping("cpu", batch=2, n_steps=1, samples=1, warmup=0,
                           env=env, cuda_graphs=True)
    with pytest.raises(ValueError, match="cuda_graphs"):
        acting.Evaluator(env, policy, 2, 2, 1, cuda_graphs=True)
    from vnl_tpu_torch.training.eval_callback import EvalCallback
    with pytest.raises(ValueError, match="cuda_graphs"):
        EvalCallback(env, "", cuda_graphs=True)


CSRC = os.path.join(os.path.dirname(compat.__file__), "csrc")


@pytest.mark.parametrize("source,group", [
    ("position.cu", "kernel A (position)"), ("cg.cu", "kernel B (cg)"),
    ("sweep.cu", "kernel C (sweep)"),
    ("constraints.cu", "kernel D (constraints)"),
    ("collision.cu", "kernel E (collision)")])
def test_kernel_groups_name_every_route_of_their_source(source, group):
    with open(os.path.join(CSRC, source)) as f:
        names = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\)"
                           r"\s*)?(\w+)\(", f.read())
    assert names and all(n.endswith("_kernel") for n in names)
    for name in names:
        for shown in (f"void {name}<8, 2>(PosModel, float const*, int)",
                      f"_Z{len(name)}{name}ILi5EEv8CgModel"):
            assert [g for g, pattern in profile_rollout.KERNEL_GROUPS
                    if pattern.search(shown)] == [group], shown


def test_kernel_groups_leave_pytorchs_kernels_out():
    for shown in (
            "void at::native::elementwise_kernel<128, 2, "
            "at::native::gpu_kernel_impl_nocast<...>>(int, ...)",
            "void at::native::reduce_kernel<512, 1, ...>(...)",
            "ampere_sgemm_128x64_nn", "Memcpy DtoD (Device -> Device)",
            "void at::native::vectorized_elementwise_kernel<4, ...>"):
        assert not any(pattern.search(shown) for _, pattern in
                       profile_rollout.KERNEL_GROUPS), shown


@pytest.fixture
def graphs_on_the_cpu(stub_graphs, monkeypatch):
    """The stub graphs, and cuda_graphs=True allowed on CPU tensors; torch
    on one thread meanwhile (the test processes share the cores)."""
    monkeypatch.setattr(graphs, "enabled", lambda c, device, what: bool(c))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EVAL_ENVS, EVAL_STEPS = 2, 3


def _eval_noise(seed, steps=EVAL_STEPS, n=EVAL_ENVS):
    rng = np.random.default_rng(seed)
    return {"start_frame": torch.zeros(n, dtype=torch.long),
            "reset": torch.tensor(1e-3 * rng.normal(size=(n, 74)),
                                  dtype=torch.float32),
            "latent": [torch.tensor(rng.normal(size=(n, 64)),
                                    dtype=torch.float32)
                       for _ in range(steps)]}


@pytest.mark.parametrize("with_noise", [False, True])
def test_graphed_evaluator_matches_eager(twin, graphs_on_the_cpu,
                                         with_noise):
    """Two evaluations each way, the policy's weights changed in place
    between them (as train's updates change them): the metrics and the
    final state bit for bit; the graphed Evaluator captures one graph and
    replays it in the second evaluation."""
    env, _ = twin
    runs = []
    for cuda_graphs in (False, True):
        keeper = compat.policy_from_numpy(compat.KEEPER_POLICY, device="cpu")
        evaluator = acting.Evaluator(
            env, make_inference_fn(keeper)(deterministic=False),
            num_eval_envs=EVAL_ENVS, episode_length=EVAL_STEPS,
            action_repeat=1, generator=torch.Generator().manual_seed(5),
            cuda_graphs=cuda_graphs)
        out = []
        for k in range(2):
            metrics = evaluator.run_evaluation(
                {}, noise=_eval_noise(k) if with_noise else None)
            out.append(({n: torch.as_tensor(np.asarray(v))
                         for n, v in metrics.items()
                         if n not in ("eval/walltime", "eval/sps",
                                      "eval/epoch_eval_time")},
                        graphs.clone(evaluator.last_state)))
            with torch.no_grad():
                keeper.action_head.weight.mul_(1.25)
        assert len(evaluator._graphs) == int(cuda_graphs)
        runs.append(out)
    _assert_bits_equal(runs[1], runs[0])
    assert sorted(runs[0][0][0]) == sorted(runs[1][0][0])
    # the second evaluation saw the new weights
    assert not torch.equal(runs[0][0][0]["eval/episode_reward"],
                           runs[0][1][0]["eval/episode_reward"])


def test_graphed_eval_callback_matches_eager(graphs_on_the_cpu):
    """EvalCallback.rollout graphed against eager over two calls from one
    generator reseeded (stopping at done, and with the noise kinds given),
    every series bit for bit; each step's qpos lands in its own row (the
    graph's outputs are one static tensor, overwritten each replay); the
    callers' policy modules keep their own weights."""
    from vnl_tpu_torch.training.eval_callback import EvalCallback
    env = make_twin_env(device="cpu", fused_position=False,
                        physics_steps_per_control_step=2)
    rng = np.random.default_rng(9)
    given = {k: [torch.tensor(rng.normal(size=(1, n)), dtype=torch.float32)
                 for _ in range(EVAL_STEPS)]
             for k, n in (("latent", 64), ("action", 30))}
    runs = []
    for cuda_graphs in (False, True):
        cb = EvalCallback(env, "", episode_length=EVAL_STEPS, plots=False,
                          cuda_graphs=cuda_graphs)
        gen = torch.Generator()
        out, keepers = [], []
        for call in range(2):
            keeper = compat.policy_from_numpy(compat.KEEPER_POLICY,
                                              device="cpu")
            with torch.no_grad():
                keeper.action_head.bias.add_(0.1 * call)
            keepers.append((keeper, {k: v.clone() for k, v in
                                     keeper.state_dict().items()}))
            for stop, noise in ((False, None), (True, None), (False, given)):
                traj = cb.rollout(keeper, gen.manual_seed(call), noise,
                                  stop_at_done=stop)
                out.append({k: torch.as_tensor(np.asarray(v))
                            for k, v in traj.items()})
        assert len(cb._graphs) == (2 if cuda_graphs else 0)
        for keeper, before in keepers:
            _assert_bits_equal(keeper.state_dict(), before)
        runs.append(out)
    _assert_bits_equal(runs[1], runs[0])
    qpos = runs[1][0]["qpos"]
    assert qpos.shape == (EVAL_STEPS, 74)
    assert all(not torch.equal(qpos[t], qpos[t + 1])
               for t in range(EVAL_STEPS - 1))
    assert not torch.equal(runs[1][0]["action"], runs[1][3]["action"])
