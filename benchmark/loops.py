"""The one traffic generator.  A traffic mix is a file of parameters
(``traffic/<mix>.json``); its ``loop`` names the loop here that drives
the program (vnl_tpu_torch) through a set-up, a measured window and the
states the judge reads afterwards:

- ``train``: ``vnl_tpu_torch.training.train`` as its command line runs it
  on the card (graphs on), with the configuration's envs a GPU, networks,
  PPO settings and evaluation schedule, and weights made from the seed.
  The window is whole training steps (a rollout, the normaliser, the SGD
  passes), cut where train() synchronises at the start of a step: it
  opens at the start of the first step from ``warm_up_steps`` on at which
  the card reads fast (device.py) and closes at the start of the first
  step that begins at or after ``seconds``.  The
  configuration's evaluation comes every ``eval_every`` env steps, far
  beyond any window; one falling inside it is an error.

The first training steps' updates, the first batch's observations and
one control step after the window are recorded for the judge
(judge.py).  A traced run traces the step before the window whole; the
window itself runs untraced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark import device as device_lib
from benchmark import trace as trace_lib
from benchmark.counts import peaks


class WindowClosed(Exception):
    """Raised from inside train() to end the run."""


@dataclasses.dataclass
class Run:
    """What a loop hands back to the harness."""

    setup_parts: Dict[str, float]    # seconds from process start
    window_s: float = 0.0
    env_steps: int = 0
    attempted: int = 0
    window_steps: int = 0            # training steps in the window
    rollout_s: List[float] = dataclasses.field(default_factory=list)
    sgd_s: List[float] = dataclasses.field(default_factory=list)
    warm_up_s: List[float] = dataclasses.field(default_factory=list)
    traced_control_steps: int = 0
    trace: Optional[trace_lib.Trace] = None
    precision: str = "fp32"          # of the networks' matrix products
    busy_s: float = 0.0              # of the traced step
    traced_window_s: float = 0.0
    memory_peak_bytes: int = 0       # the whole run, read at the close
    us_per_node_open: Optional[float] = None    # device.py, at the open
    us_per_node_close: Optional[float] = None   # ... and the close
    window_peak_bytes: int = 0       # the window alone
    judge_inputs: Dict = dataclasses.field(default_factory=dict)


def resolve(path: str) -> Callable:
    """"module:attribute" -> the attribute."""
    module, attr = path.split(":")
    return getattr(importlib.import_module(module), attr)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def seeded_weights(named_shapes: Dict[str, torch.Size], seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """Initial weights of the networks from the seed, made on the device
    in one draw: each matrix N(0, 1 / fan_in), biases zero, LayerNorm
    scales one."""
    gen = torch.Generator(device=device).manual_seed(seed)
    mats = {n: s for n, s in named_shapes.items() if len(s) == 2}
    total = sum(math.prod(s) for s in mats.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in named_shapes.items():
        if name in mats:
            k = math.prod(shape)
            out[name] = (flat[at:at + k].view(shape)
                         * (1.0 / math.sqrt(shape[1])))
            at += k
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def load_weights(module: torch.nn.Module,
                 weights: Dict[str, torch.Tensor]) -> None:
    named = dict(module.named_parameters())
    if set(named) != set(weights):
        raise ValueError("the networks' parameters are not the ones the "
                         "weights were made for")
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(weights[name])


@contextlib.contextmanager
def patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def tree_map_tensors(fn: Callable, x):
    """``fn`` over the tensors of a nest of dicts, lists, tuples and
    dataclasses."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: tree_map_tensors(fn, v) for k, v in x.items()}
    if isinstance(x, list):
        return [tree_map_tensors(fn, v) for v in x]
    if isinstance(x, tuple):
        vals = [tree_map_tensors(fn, v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: tree_map_tensors(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def clone_tree(x):
    return tree_map_tensors(lambda t: t.detach().clone(), x)


def check_sizes(config: Dict, traj: int, obs: int, act: int) -> None:
    want = config["sizes"]
    got = dict(traj_size=traj, obs_size=obs, action_size=act)
    if got != want:
        raise ValueError(f"the env's sizes {got} are not the "
                         f"configuration's {want}")


def train_kwargs(ppo: Dict) -> Dict:
    """train()'s keywords from a configuration's PPO settings: its
    evaluation schedule (``eval_every`` env steps) as train()'s count of
    evaluations."""
    kw = dict(ppo)
    every = kw.pop("eval_every")
    kw["num_evals"] = kw["num_timesteps"] // every + 1
    return kw


class _Recorder:
    """Reads the program's state at the boundaries the judge needs: the
    networks and optimizer train() builds, the first three updates (their
    minibatch, the generator's state before each, the loss), Adam's first
    moments and the normaliser in force after the first, the parameters
    after the third, the first batch's observations and the normaliser
    state they were folded into, and the last unroll's env, policy,
    generator, control-step graph and final state."""

    RECORDED_UPDATES = 3

    def __init__(self):
        self.net = None
        self.init_weights = None
        self.optimizer = None
        self.generator = None
        self.actor = None
        self.updates = 0
        self.minibatches: List = []
        self.gen_states: List[torch.Tensor] = []
        self.losses: List[float] = []
        self.exp_avg1: Optional[List[torch.Tensor]] = None
        self.params3: Optional[Dict[str, torch.Tensor]] = None
        self.first_obs: Optional[torch.Tensor] = None
        self.first_norm_state = None
        self.normalizer1 = None


def run_train(cell, seed: int, seconds: float, traced: bool, device,
              parts: Dict[str, float], t0: float) -> Run:
    from vnl_tpu_torch import models
    from vnl_tpu_torch.training import (acting, gradients,
                                        running_statistics)
    train_mod = importlib.import_module("vnl_tpu_torch.training.train")

    cfg, traffic = cell.config, cell.traffic
    ppo = cfg["ppo"]
    warm = int(traffic["warm_up_steps"])
    samples = ppo["batch_size"] * ppo["num_minibatches"]
    per_step = samples * ppo["unroll_length"]
    unrolls_per_step = samples // ppo["num_envs"]
    rec = _Recorder()
    run = Run(setup_parts=parts)

    env = resolve(cfg["program"]["env"])(device=device, **cfg["env_args"])
    parts["env_built"] = time.perf_counter() - t0

    def factory(traj_size, obs_size, action_size, generator=None,
                device=device):
        check_sizes(cfg, traj_size, obs_size, action_size)
        net = models.make_intention_ppo_networks(
            traj_size, obs_size, action_size, generator=generator,
            device=device, **cfg["networks"])
        weights = seeded_weights(
            {n: p.shape for n, p in net.named_parameters()}, seed, device)
        load_weights(net, weights)
        rec.net, rec.init_weights = net, weights
        return net

    real_update_fn = gradients.gradient_update_fn

    def update_fn(loss_fn, optimizer, **kw):
        rec.optimizer = optimizer
        rec.generator = (kw.get("generators") or (None,))[0]
        inner = real_update_fn(loss_fn, optimizer, **kw)

        def update(minibatch):
            n = rec.updates
            if n < rec.RECORDED_UPDATES:
                rec.minibatches.append(clone_tree(minibatch))
                rec.gen_states.append(rec.generator.get_state())
            out = inner(minibatch)
            if n < rec.RECORDED_UPDATES:
                rec.losses.append(float(out[0].detach()))
            if n == 0:
                rec.exp_avg1 = [m.detach().clone()
                                for m in optimizer.exp_avg]
                rec.normalizer1 = (rec.net.policy.obs_mean.clone(),
                                   rec.net.policy.obs_std.clone())
            if n == rec.RECORDED_UPDATES - 1:
                rec.params3 = {k: p.detach().clone()
                               for k, p in rec.net.named_parameters()}
            rec.updates = n + 1
            return out
        return update

    # host times at train()'s synchronisations: the start of each training
    # step (before its rollout) and the end of its rollout
    starts: List[float] = []
    rollout_ends: List[float] = []
    real_stats_update = running_statistics.update

    def stats_update(state, batch, **kw):
        rollout_ends.append(time.perf_counter())
        if rec.first_obs is None:
            rec.first_obs = batch.detach().clone()
            rec.first_norm_state = clone_tree(state)
        return real_stats_update(state, batch, **kw)

    tracer = trace_lib.Tracer() if traced else None
    probe = device_lib.LaunchProbe(device)
    unrolls = [0]
    phase = {"open": None, "traced": None}     # the steps they begin at

    def step_starts(n: int) -> None:
        """Training step ``n`` starts; train() has synchronised.  After
        ``warm_up_steps`` steps, once the card reads fast (device.py), a
        traced run traces one step and the window opens at the next."""
        if phase["open"] is None and phase["traced"] is None and \
                n >= warm and (probe.fast() or time.perf_counter() - t0
                               >= device_lib.WAIT_CAP_S):
            if tracer is None:
                phase["open"] = n
            else:
                phase["traced"] = n
                tracer.start()
                tracer.mark()
        elif phase["traced"] is not None and phase["open"] is None:
            tracer.stop()
            run.trace = tracer.trace
            run.busy_s = run.trace.busy_s
            run.traced_window_s = run.trace.window_s
            run.traced_control_steps = unrolls_per_step * \
                ppo["unroll_length"]
            phase["open"] = n
        now = time.perf_counter()
        if n == phase["open"]:                         # the window opens
            parts["warm_up"] = now - t0
            run.us_per_node_open = probe.us_per_node()
            if torch.device(device).type == "cuda":
                run.memory_peak_bytes = torch.cuda.max_memory_allocated(
                    device)
                torch.cuda.reset_peak_memory_stats(device)
            now = time.perf_counter()
        elif phase["open"] is not None and \
                now - starts[phase["open"]] >= seconds:
            starts.append(now)
            raise WindowClosed
        starts.append(now)

    real_unroll = acting.generate_unroll

    def unroll(env, env_state, policy, generator, unroll_length,
               extra_fields=(), step=None):
        if unrolls[0] % unrolls_per_step == 0:
            step_starts(unrolls[0] // unrolls_per_step)
        unrolls[0] += 1
        state, out = real_unroll(env, env_state, policy, generator,
                                 unroll_length, extra_fields=extra_fields,
                                 step=step)
        rec.actor = (env, policy, generator, tuple(extra_fields), step,
                     state)
        return state, out

    def progress(step, metrics):
        if step != 0:
            raise RuntimeError("an evaluation fell inside the window: "
                               "eval_every is too small for it")
        parts["first_evaluation"] = time.perf_counter() - t0

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(gradients, "gradient_update_fn",
                                    update_fn))
        stack.enter_context(patched(running_statistics, "update",
                                    stats_update))
        stack.enter_context(patched(acting, "generate_unroll", unroll))
        try:
            train_mod.train(env, seed=seed, network_factory=factory,
                            progress_fn=progress, device=device,
                            **train_kwargs(ppo))
            raise RuntimeError("train() ended before the window closed")
        except WindowClosed:
            pass
    sync(device)
    if torch.device(device).type == "cuda":
        run.window_peak_bytes = torch.cuda.max_memory_allocated(device)
        run.memory_peak_bytes = max(run.memory_peak_bytes,
                                    run.window_peak_bytes)
    run.precision = peaks.precision(next(rec.net.parameters()).dtype)
    opened, end = phase["open"], len(starts) - 1
    run.us_per_node_close = probe.us_per_node()
    run.window_steps = end - opened
    run.window_s = starts[end] - starts[opened]
    run.env_steps = run.window_steps * per_step
    run.attempted = run.window_steps
    run.rollout_s = [rollout_ends[n] - starts[n] for n in range(opened, end)]
    run.sgd_s = [starts[n + 1] - rollout_ends[n] for n in range(opened, end)]
    run.warm_up_s = [starts[n + 1] - starts[n] for n in range(opened)]

    # one more control step of the window's own graph, for the judge: the
    # program's env step from the state the window reached
    env_w, policy, generator, extra, graph, state = rec.actor
    pre = clone_tree(state)
    if graph is not None:
        post, transition = graph(state)
    else:                      # eager (the CPU)
        post, transition = acting.actor_step(env_w, state, policy,
                                             generator, extra)
    run.judge_inputs = dict(
        pre=pre, action=transition.action.clone(), post=clone_tree(post),
        init_weights=rec.init_weights, minibatches=rec.minibatches,
        gen_states=rec.gen_states, losses=rec.losses,
        grad1=[m / (1.0 - rec.optimizer.b1) for m in rec.exp_avg1],
        param_names=[n for n, _ in rec.net.named_parameters()],
        params3=rec.params3, first_obs=rec.first_obs,
        first_norm_state=rec.first_norm_state,
        normalizer1=rec.normalizer1)
    return run


LOOPS = {"train": run_train}
