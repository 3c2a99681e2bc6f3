"""The humanoid as the benchmark runs it (configuration
``humanoid_tracking``), on the CPU at small sizes:

(a) the reference's model (benchmark/reference/assets/humanoid_model.npz)
is the port's compile of the committed suite humanoid under the humanoid
envs' solver options, bit for bit;
(b) the port's HumanoidTracking against the benchmark's plain copy of it
(benchmark/reference/plain/envs/humanoid.py), wrapped for training, at 4
envs over 3 control steps with seeded actions, each stepping its own
state: qpos, qvel, obs and reward within 1e-5 of the env's largest entry
(or 1), done equal;
(c) one learner update at the configuration's sizes and widths on a
humanoid rollout, the port's networks, loss and Adam against the
reference's from the same weights and noise: the loss within a relative
1e-5, Adam's first moment within 1e-5 of each leaf's largest entry;
(d) kernel D's bytes of benchmark/counts/constraints.py against
chip_smoke.py's ``constraints_bytes`` on the twin and the humanoid;
(e) the control step's part tags (utils/graphs.py ``part``) cover it: an
eager in-place control step of each body, every aten operation counted
by the innermost part open, leaves none outside the eight parts."""

import functools
import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import judge, loops, spec
from benchmark.counts import constraints as con_counts
from benchmark.counts import scene
from benchmark.reference.plain.envs.humanoid import (HUMANOID_MODEL,
                                                     make_humanoid_env)
from benchmark.reference.plain.envs.wrappers import \
    wrap_for_training as ref_wrap
from tools import export_torch_assets as exporter
from vnl_tpu_torch import compat
from vnl_tpu_torch import mjcf as tmjcf
from vnl_tpu_torch.envs import (HumanoidTracking, make_twin_env,
                                step_in_place, wrap_for_training)
from vnl_tpu_torch.utils import graphs, profiler


PARTS = {"position", "collision", "constraints", "velocity", "solve",
         "integrate", "env", "policy"}
CONFIG = os.path.join(spec.ROOT, "benchmark", "configs",
                      "humanoid_tracking.json")


@pytest.fixture(scope="module")
def cfg():
    with open(CONFIG) as f:
        return json.load(f)


def test_reference_model_is_the_ports_compile():
    got = tmjcf.compile_numpy(tmjcf.load_spec(compat.DM_HUMANOID_XML,
                                              **exporter.HUMANOID_COMPILE))
    with np.load(HUMANOID_MODEL) as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def _gap(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs().amax(-1)
                  / b.abs().amax(-1).clamp(min=1.0)).max())


def test_port_env_matches_the_reference_copy(cfg):
    env = wrap_for_training(HumanoidTracking(device="cpu", **cfg["env_args"]),
                            episode_length=cfg["ppo"]["episode_length"])
    ref = ref_wrap(make_humanoid_env(device="cpu", **cfg["env_args"]),
                   episode_length=cfg["ppo"]["episode_length"])
    state = env.reset(4, generator=torch.Generator().manual_seed(11))
    assert (state.info["traj"].shape[-1], state.obs.shape[-1],
            env.action_size) == tuple(cfg["sizes"].values())
    ref_state = judge.to_reference(state)
    draws = torch.Generator().manual_seed(12)
    for _ in range(3):
        action = 2 * torch.rand(4, env.action_size, generator=draws) - 1
        state = env.step(state, action)
        ref_state = ref.step(ref_state, action)
        for name in ("qpos", "qvel"):
            assert _gap(getattr(state.pipeline_state, name),
                        getattr(ref_state.pipeline_state, name)) <= 1e-5, name
        assert _gap(state.obs, ref_state.obs) <= 1e-5
        assert _gap(state.reward[:, None], ref_state.reward[:, None]) <= 1e-5
        assert torch.equal(state.done, ref_state.done)


def test_one_learner_update_matches_the_reference(cfg):
    from vnl_tpu_torch import models
    from vnl_tpu_torch.training import compute_ppo_intention_loss
    from vnl_tpu_torch.training.gradients import Adam
    from vnl_tpu_torch.training.train import collect_rollouts
    from vnl_tpu_torch.training.types import Transition
    from benchmark.reference.plain.models.ppo_networks import \
        make_intention_ppo_networks as ref_networks
    from benchmark.reference.plain.training.gradients import Adam as RefAdam
    from benchmark.reference.plain.training.losses import \
        compute_ppo_intention_loss as ref_loss
    from benchmark.reference.plain.training.types import \
        Transition as RefTransition

    sizes, ppo = cfg["sizes"], cfg["ppo"]
    env = wrap_for_training(HumanoidTracking(
        device="cpu", physics_steps_per_control_step=2), episode_length=8)
    gen = torch.Generator().manual_seed(21)
    state = env.reset(4, generator=gen)
    nets = []
    for make in (models.make_intention_ppo_networks, ref_networks):
        net = make(sizes["traj_size"], sizes["obs_size"],
                   sizes["action_size"], device="cpu", **cfg["networks"])
        weights = loops.seeded_weights(
            {n: p.shape for n, p in net.named_parameters()}, 22, "cpu")
        loops.load_weights(net, weights)
        nets.append(net)
    policy = models.make_inference_fn(nets[0])(deterministic=False)
    _, batch = collect_rollouts(env, state, policy, gen, 3, 1)
    out = []
    for net, loss_fn, adam, tr in (
            (nets[0], compute_ppo_intention_loss, Adam, Transition),
            (nets[1], ref_loss, RefAdam, RefTransition)):
        opt = adam(net.parameters(), ppo["learning_rate"])
        opt.zero_grad()
        loss, _ = loss_fn(net, tr(*batch),
                          generator=torch.Generator().manual_seed(23),
                          **judge.loss_kwargs(ppo))
        loss.backward()
        opt.step()
        out.append((float(loss.detach()), [m.clone() for m in opt.exp_avg]))
    (loss, moment), (ref_loss_value, ref_moment) = out
    assert loss == pytest.approx(ref_loss_value, rel=1e-5)
    assert len(moment) == len(ref_moment) == len(list(nets[0].parameters()))
    for m, r in zip(moment, ref_moment):
        assert m.shape == r.shape
        scale = max(float(r.abs().max()), 1e-30)
        assert float((m - r).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("cell", ["twin_train", "humanoid_train"])
def test_kernel_d_bytes_are_chip_smokes(cell):
    import chip_smoke
    from vnl_tpu_torch.ops import constraints as con_ops
    from vnl_tpu_torch.physics import collision

    config = spec.cell(cell).config
    s = scene.shapes(config)
    env = loops.resolve(config["program"]["env"])(device="cpu")
    m = env.sys
    pair = collision.pair_expansion(m)
    t = con_ops.kernel_tables(m, pair)
    nlimit, ncon = len(t["lim_dof"]), len(pair)
    nroot = len(np.unique(t["con_int"][:2]))
    assert (nlimit, ncon, nroot) == (s["nlimit"], s["ncon"],
                                     con_counts.contact_roots(config))
    for batch in (1, 128, 1024):
        want = chip_smoke.constraints_bytes(m, batch, nlimit, ncon, nroot)
        assert con_counts.constraints_bytes(s["nv"], nlimit, ncon, nroot,
                                            batch) == want
        assert con_counts.constraints_cost(config, s, batch) == \
            (float(want), 0.0)


@pytest.mark.parametrize("cell", ["twin_train", "humanoid_train",
                                  "cmu_train"])
def test_kernel_e_bytes_are_chip_smokes(cell):
    """benchmark/counts/collision.py's bytes of a launch, read from the
    reference's model, are chip_smoke.py's from the program's."""
    import chip_smoke
    from benchmark.counts import collision as col_counts

    config = spec.cell(cell).config
    m = loops.resolve(config["program"]["env"])(
        device="cpu", **config.get("env_args", {})).sys
    for batch in (1, 128, 1024):
        assert col_counts.collision_cost(config, batch) == \
            (float(chip_smoke.collision_bytes(m, batch)), 0.0)


class _Ops(TorchDispatchMode):
    """Counts the aten operations dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("body", ["twin", "humanoid"])
def test_the_part_tags_cover_the_control_step(body):
    from vnl_tpu_torch import models
    from vnl_tpu_torch.training.acting import actor_step
    if body == "twin":
        raw = make_twin_env(device="cpu", physics_steps_per_control_step=2)
    else:
        raw = HumanoidTracking(device="cpu",
                               physics_steps_per_control_step=2)
    env = wrap_for_training(raw, episode_length=4)
    gen = torch.Generator().manual_seed(31)
    state = graphs.clone(env.reset(2, generator=gen))
    net = models.make_intention_ppo_networks(
        state.info["traj"].shape[-1], state.obs.shape[-1], env.action_size,
        intention_latent_size=8, encoder_layer_sizes=(16,),
        decoder_layer_sizes=(16,), value_hidden_layer_sizes=(16,),
        generator=torch.Generator().manual_seed(32), device="cpu")
    policy = models.make_inference_fn(net)(deterministic=False)
    step = functools.partial(actor_step, env, policy=policy, generator=gen,
                             extra_fields=("truncation", "traj"))
    ops = _Ops()
    with ops, profiler.parts_counted(lambda: ops.n) as counts:
        step_in_place(step, state)
    assert counts.outside == 0
    assert set(counts.counts) == PARTS
    assert sum(counts.counts.values()) == ops.n
    assert all(n > 0 for n in counts.counts.values()), dict(counts.counts)


def test_parts_go_to_the_innermost_tag():
    reads = iter(range(0, 100, 10))      # each read, 10 more than the last
    with profiler.parts_counted(lambda: next(reads)) as counts:   # reads 0
        with profiler.part("env"):                      # 10 ... 60
            with profiler.part("collision"):            # 20 ... 30
                pass
            with profiler.part("solve"):                # 40 ... 50
                pass
        with profiler.part("policy"):                   # 70 ... 80
            pass
    # the block's end reads 90
    assert dict(counts.counts) == {"env": 30, "collision": 10, "solve": 10,
                                   "policy": 10}
    assert counts.outside == 30
    with profiler.part("env"):           # no count open: the tag does nothing
        pass


def test_part_tags_of_another_thread_are_not_counted():
    """A capture counts the tags of its own thread alone: another thread's
    tag (a render job's physics) neither reads the count nor is put down
    to a part."""
    reads = []

    def read():
        reads.append(threading.get_ident())
        return 10 * len(reads)

    def other():
        with profiler.part("collision"):
            pass

    with profiler.parts_counted(read) as counts:
        with profiler.part("env"):
            worker = threading.Thread(target=other)
            worker.start()
            worker.join()
    assert set(reads) == {threading.get_ident()}
    assert dict(counts.counts) == {"env": 10}


def test_part_tags_are_profiler_ranges():
    """Under an active torch.profiler each tag is a ``part.<name>`` range
    holding the operations inside it, so that a trace of an eager step
    gives each part's time."""
    x = torch.ones(8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.part("collision"):
            torch.sin(x)
    names = {e.name for e in prof.events()}
    assert "part.collision" in names and "aten::sin" in names
    (tag,) = [e for e in prof.events() if e.name == "part.collision"]
    assert "aten::sin" in {c.name for c in tag.cpu_children}

