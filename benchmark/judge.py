"""How ``correct`` is decided: what the timed path produced, held against
the plain reference (``reference/plain``, a frozen copy of the port's
plain PyTorch paths that imports nothing of the port).

- The env step (every cell): after the window closes, the window's own
  control-step graph steps once more from the state the window reached;
  the reference steps the same state (every env of the batch) with the
  action the program applied, and the post-step states are compared.
- The learner (training cells): the reference starts from the weights
  the benchmark made from the seed, works out the normaliser again from
  the first batch's observations, and follows the program's first three
  updates on the same minibatches with the same noise (the generator's
  state before each update).  It compares each update's loss, the first
  gradient as Adam received it (its first moment after one step over
  1 - b1), and the parameters' change after three updates.  The
  minibatches are the program's own rollout: the reference follows the
  program from its state there, and the env check above covers the step
  that made them.

Gradients and changes are compared leaf by leaf, as the gap between the
program's norm and the reference's over the larger of the reference's norm
of that leaf and of the median leaf; leaves whose reference gradient is
under a thousandth of the median leaf's are left out (they move by
rounding alone).  The reference runs in float32 with TF32 off; the
control (``control.py``) runs it with TF32 on in the program's place."""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
from typing import Dict, List, Tuple

import torch

from benchmark import loops

SMALL_LEAF = 1e-3


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------------------
# the env step
# ---------------------------------------------------------------------------

def to_reference(x, dtype=torch.float32):
    """A program State (with its Data) as the reference's classes, every
    tensor cloned and every floating one in ``dtype``."""
    from benchmark.reference.plain.envs.base import State
    from benchmark.reference.plain.physics.model import Data
    if isinstance(x, torch.Tensor):
        x = x.detach().clone()
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: to_reference(v, dtype) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        cls = {"State": State, "Data": Data}[type(x).__name__]
        return cls(**{f.name: to_reference(getattr(x, f.name), dtype)
                      for f in dataclasses.fields(x)})
    return x


def reference_env(cfg: Dict, device, dtype=torch.float32):
    from benchmark.reference.plain.envs.wrappers import wrap_for_training
    env = loops.resolve(cfg["reference"]["env"])(
        device=device, dtype=dtype, **cfg["env_args"])
    return wrap_for_training(env, episode_length=cfg["ppo"]["episode_length"])


@torch.no_grad()
def reference_step(cfg: Dict, pre, action: torch.Tensor, device,
                   tf32: bool = False, dtype=torch.float32):
    """The reference's control step of every env from the program's
    pre-step state with the program's action."""
    with matmul_precision(tf32):
        return reference_env(cfg, device, dtype).step(
            to_reference(pre, dtype), action.to(dtype))


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per env: the largest |a - b| over the env's entries, over the
    largest |b| of the env or 1."""
    a, b = a.double(), b.double()
    return (a - b).abs().amax(-1) / b.abs().amax(-1).clamp(min=1.0)


def _state_gap(a, b) -> torch.Tensor:
    """Per env: the larger of the qpos gap and the qvel gap, each
    relative to the env's largest entry of ``b``'s or 1."""
    return torch.maximum(
        _gap(a.pipeline_state.qpos, b.pipeline_state.qpos),
        _gap(a.pipeline_state.qvel, b.pipeline_state.qvel))


# a float32 evaluation is off the exact answer by a few ulps at least
EXCESS_FLOOR = 1e-6


def _excess(gap, post, ref, exact, moved) -> torch.Tensor:
    """Per env: the program's ``gap`` to the float64 reference over how
    far rounding moves that env (the float32 reference's gap and each
    nudged float64 reference's, plus a floor)."""
    sens = gap(ref, exact)
    for m in moved:
        sens = torch.maximum(sens, gap(m, exact))
    return gap(post, exact) / (sens + EXCESS_FLOOR)


def _obs_gap(a, b) -> torch.Tensor:
    return _gap(a.obs, b.obs)


def _reward_gap(a, b) -> torch.Tensor:
    return _gap(a.reward.unsqueeze(-1), b.reward.unsqueeze(-1))


def env_numbers(post, ref, exact, moved=()) -> Dict[str, float]:
    """The program's post-step state (``post``) against the float32
    reference's (``ref``), the float64 reference's (``exact``) and the
    float64 reference's from nudged inputs (``moved``).  Gaps are per env
    (the larger of the qpos and qvel gaps; each relative to the env's
    largest entry or 1).  ``state_excess``, ``obs_excess`` and
    ``reward_excess``: the worst env's gap to the float64 reference in
    units of how far rounding moves that env (_excess), so that an env
    whose solve rounding itself moves far (stiff contacts under 6 CG
    iterations) counts as far as rounding moves it and no more;
    ``state_excess_p99``: the 99th percentile of the state's;
    ``obs_p50``: the median env's observation gap to the float32
    reference; ``done_flips``: envs whose ``done`` differs from the
    float64 reference's where every reference agrees on it."""
    g32 = _state_gap(post, ref)
    excess = _excess(_state_gap, post, ref, exact, moved)
    obs = _gap(post.obs, ref.obs)
    agreed = (ref.done == exact.done)
    for m in moved:
        agreed &= (m.done == exact.done)
    return {"state_p50": float(g32.median()), "state_max": float(g32.max()),
            "state_excess": float(excess.max()),
            "state_excess_p99": float(excess.quantile(0.99)),
            "obs_p50": float(obs.median()), "obs_max": float(obs.max()),
            "obs_excess": float(
                _excess(_obs_gap, post, ref, exact, moved).max()),
            "reward_max": float(_reward_gap(post, exact).max()),
            "reward_excess": float(
                _excess(_reward_gap, post, ref, exact, moved).max()),
            "done_flips": float(((post.done != exact.done)
                                 & agreed).sum())}


def nudged(pre, sign: float):
    """The pre-step state with qpos and qvel moved by a relative 1e-7
    (about one float32 rounding) in a fixed pattern of signs."""
    ps = pre.pipeline_state
    gen = torch.Generator().manual_seed(0)

    def move(x):
        r = torch.randint(0, 2, x.shape[1:], generator=gen) * 2.0 - 1.0
        return x * (1.0 + sign * 1e-7 * r.to(x.device, x.dtype))
    return pre.replace(pipeline_state=ps.replace(qpos=move(ps.qpos),
                                                 qvel=move(ps.qvel)))


def env_check(cfg: Dict, inputs: Dict, device) -> Dict[str, float]:
    """The env step judged against float32 and float64 references.  How
    far rounding moves each env is the widest of the float32 reference's
    gap to the float64 one and the float64 reference's own moves under
    two nudges of its input by about one float32 rounding: a stiff env
    amplifies all three."""
    pre, action, post = inputs["pre"], inputs["action"], inputs["post"]
    ref = reference_step(cfg, pre, action, device)
    exact = reference_step(cfg, pre, action, device, dtype=torch.float64)
    moved = [reference_step(cfg, nudged(to_reference(pre, torch.float64),
                                        sign), action, device,
                            dtype=torch.float64) for sign in (1.0, -1.0)]
    return env_numbers(post, ref, exact, moved)


# ---------------------------------------------------------------------------
# the learner
# ---------------------------------------------------------------------------

def loss_kwargs(ppo: Dict) -> Dict:
    return {k: ppo[k] for k in ("entropy_cost", "discounting",
                                "reward_scaling", "gae_lambda",
                                "clipping_epsilon", "kl_weight")}


def reference_updates(cfg: Dict, inputs: Dict, device, tf32: bool = False,
                      half_batch: bool = False) -> Dict:
    """The reference's first three updates from the benchmark's weights,
    on the program's minibatches.  ``half_batch``: a fault, the loss over
    the first half of each minibatch's rows."""
    from benchmark.reference.plain.models.ppo_networks import \
        make_intention_ppo_networks
    from benchmark.reference.plain.training import running_statistics
    from benchmark.reference.plain.training.gradients import Adam
    from benchmark.reference.plain.training.losses import \
        compute_ppo_intention_loss
    from benchmark.reference.plain.training.types import Transition

    sizes, ppo = cfg["sizes"], cfg["ppo"]
    with matmul_precision(tf32):
        net = make_intention_ppo_networks(
            sizes["traj_size"], sizes["obs_size"], sizes["action_size"],
            device=device, **cfg["networks"])
        loops.load_weights(net, inputs["init_weights"])
        st = inputs["first_norm_state"]
        state = running_statistics.RunningStatisticsState(
            count=st.count.clone(), mean=st.mean.clone(),
            summed_variance=st.summed_variance.clone(), std=st.std.clone())
        norm = running_statistics.update(state, inputs["first_obs"])
        if ppo["normalize_observations"]:
            net.set_normalizer(norm)
        opt = Adam(net.parameters(), ppo["learning_rate"])
        names = [n for n, _ in net.named_parameters()]
        losses, grad1 = [], None
        for minibatch, gen_state in zip(inputs["minibatches"],
                                        inputs["gen_states"]):
            opt.zero_grad()
            gen = torch.Generator(device=device)
            gen.set_state(gen_state)
            data = Transition(*minibatch)
            if half_batch:
                data = loops.tree_map_tensors(
                    lambda x: x[: x.shape[0] // 2], data)
            loss, _ = compute_ppo_intention_loss(
                net, data, generator=gen, **loss_kwargs(ppo))
            loss.backward()
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {n: p.grad.detach().clone()
                         for n, p in zip(names, net.parameters())}
            opt.step()
        params3 = {n: p.detach().clone()
                   for n, p in zip(names, net.parameters())}
    return dict(losses=losses, grad1=grad1, params3=params3,
                normalizer=(norm.mean, norm.std))


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep: List[str]) -> float:
    pn = {k: float(prog[k].norm()) for k in keep}
    rn = {k: float(ref[k].norm()) for k in keep}
    median = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], median) for k in keep)


def sgd_numbers(prog: Dict, ref: Dict, init: Dict[str, torch.Tensor],
                ref_grad1: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``prog`` (as the program reached them) against ``ref``: losses,
    first gradient, change after three updates and the normaliser.
    ``ref_grad1`` (the judging reference's first gradient) picks the leaves
    that count."""
    norms = {k: float(g.norm()) for k, g in ref_grad1.items()}
    median = statistics.median(norms.values())
    keep = [k for k, v in norms.items() if v >= SMALL_LEAF * median]
    change = {k: prog["params3"][k] - init[k] for k in keep}
    ref_change = {k: ref["params3"][k] - init[k] for k in keep}
    pm, ps = prog["normalizer"]
    rm, rs = ref["normalizer"]
    return {
        "loss": max(abs(a - b) / abs(b)
                    for a, b in zip(prog["losses"], ref["losses"])),
        "grad1": _leaf_gaps(prog["grad1"], ref["grad1"], keep),
        "change3": _leaf_gaps(change, ref_change, keep),
        "normalizer": float(torch.maximum(
            ((pm - rm).abs() / rs).max(), ((ps - rs).abs() / rs).max())),
        "leaves_left_out": float(len(norms) - len(keep)),
    }


def program_learner(inputs: Dict) -> Dict:
    """The program's readings in sgd_numbers' layout."""
    return dict(losses=inputs["losses"],
                grad1=dict(zip(inputs["param_names"], inputs["grad1"])),
                params3=inputs["params3"], normalizer=inputs["normalizer1"])


# ---------------------------------------------------------------------------
# the verdict
# ---------------------------------------------------------------------------

def numbers(cfg: Dict, loop: str, inputs: Dict, device) -> Dict[str, float]:
    """Every reading of a run (the program against the reference)."""
    out = env_check(cfg, inputs, device)
    if loop == "train":
        ref = reference_updates(cfg, inputs, device)
        out.update(sgd_numbers(program_learner(inputs), ref,
                               inputs["init_weights"], ref["grad1"]))
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``correct`` and, for each number compared, its value and limit."""
    checks = {k: {"value": readings[k], "limit": float(v)}
              for k, v in limits.items()}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
