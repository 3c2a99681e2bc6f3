"""Finds where copies of one env part on the card: the first function of the
port whose outputs differ between copies of the same env while its inputs
are equal bit for bit.

``python -m vnl_tpu_torch.check_numerics`` tiles each golden's 16 envs
into copies and counts the copies that end equal to copy 0 bit for bit.
Where some do not, this script replays the goldens of one scene as that
check steps them (one batch, ``check_numerics.check_rollouts``' layout),
resets and steps them with every function of the port's physics, ops,
envs and models wrapped (and every submodule of the keeper's policy
hooked): each wrapper compares the copies of its batched tensor inputs
and outputs (Data, State and other dataclass fields included).  It
reports the reset's parted copies and, at the first control step after
which a copy of some golden differs from its copy 0 (its action
included), the functions whose inputs were equal and whose outputs were
not, innermost first, with the copies that differ, as one JSON line.

  python3 tools/find_copy_divergence.py [--scene twin] [--stage unfused]
      [--batch 1024] [--tries 3]
  python3 tools/find_copy_divergence.py --products 1024,1536,2048

The second form only tiles random inputs through the three batched
products of ``physics.inertia.assemble_qM`` at each batch size and prints
the copies each parts.

Runs on the card (the question is about its arithmetic); ``--device cpu``
rehearses it at a small ``--batch``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import importlib
import inspect
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

MODULES = ("physics.kinematics", "physics.inertia", "physics.collision",
           "physics.constraint", "physics.rne", "physics.actuation",
           "physics.solver", "physics.forward", "ops.linalg", "ops.sweep",
           "ops.cg", "ops.position", "math.spatial", "math.quaternion",
           "models.intention", "models.networks", "models.distribution",
           "models.ppo_networks", "envs.base", "envs.rodent",
           "envs.humanoid", "envs.ant")


class Layout:
    """Where the copies of each golden's envs sit in the batch."""

    def __init__(self, batch, blocks, copies, n_envs):
        self.batch, self.blocks = batch, blocks
        self.copies, self.n_envs = copies, n_envs

    def differing(self, x) -> dict:
        """{golden: [copies whose bits differ from copy 0]} of a float
        tensor whose first axis (the second of a stacked pair) is the
        batch; a tensor of one golden's block (the policy's input and
        output) counts as ``"a block"``."""
        if not torch.is_tensor(x) or x.ndim == 0 or \
                not x.is_floating_point():
            return {}
        y = x.transpose(0, 1) if x.ndim > 2 and x.shape[0] == 2 else x
        per = self.copies * self.n_envs
        if y.shape[0] == self.batch:
            blocks = self.blocks
        elif y.shape[0] == per:
            blocks = {"a block": slice(0, per)}
        else:
            return {}
        bits = y.contiguous().view(torch.int32 if y.element_size() == 4
                                   else torch.int64)
        out = {}
        for name, b in blocks.items():
            c = bits[b].reshape(self.copies, self.n_envs, -1)
            diff = (c != c[:1]).flatten(1).any(1).nonzero().flatten()
            if len(diff):
                out[name] = diff.tolist()
        return out

    def of_tree(self, obj, depth=0) -> dict:
        """``differing`` over every tensor of args, tuples, dicts and
        dataclasses."""
        if torch.is_tensor(obj):
            return self.differing(obj)
        out = {}
        if depth > 4:       # a State's Data fields inside a call's args
            return out
        items = []
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            items = [getattr(obj, f.name, None)
                     for f in dataclasses.fields(obj)]
        elif isinstance(obj, (list, tuple)):
            items = list(obj)
        elif isinstance(obj, dict):
            items = list(obj.values())
        for it in items:
            for k, v in self.of_tree(it, depth + 1).items():
                out[k] = sorted(set(out.get(k, [])) | set(v))
        return out


def wrap_all(layout, events, active):
    """Wraps every function defined in MODULES, in every module that holds
    a reference to it, and every method of the classes defined there (the
    envs' observation and reward methods, the networks' ``forward``);
    returns a function that undoes it."""
    mods = [importlib.import_module(f"vnl_tpu_torch.{m}") for m in MODULES]

    def ours(fn):
        return inspect.isfunction(fn) and \
            fn.__module__.startswith("vnl_tpu_torch")

    def wrapper(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            if not active[0]:
                return fn(*args, **kw)
            before = layout.of_tree((args, kw))
            out = fn(*args, **kw)
            new = {k: v for k, v in layout.of_tree(out).items()
                   if k not in before}
            if new:
                events.append({"function": f"{fn.__module__}."
                               f"{fn.__qualname__}", "copies": new})
            return out
        return inner

    wrapped, undo = {}, []
    for mod in mods:
        for name, obj in list(vars(mod).items()):
            if ours(obj):
                fn = wrapped.setdefault(id(obj), wrapper(obj))
                setattr(mod, name, fn)
                undo.append((mod, name, obj))
            elif inspect.isclass(obj) and obj.__module__ == mod.__name__:
                for attr, meth in list(vars(obj).items()):
                    if ours(meth) and not attr.startswith("__"):
                        setattr(obj, attr, wrapper(meth))
                        undo.append((obj, attr, meth))

    def restore():
        for owner, name, obj in reversed(undo):
            setattr(owner, name, obj)
    return restore


def hook_modules(net, layout, events, active):
    """Forward hooks on every submodule of ``net`` (torch's Linear and
    LayerNorm included) that record an output whose copies part while its
    inputs' do not."""
    def hook(name):
        def fn(mod, inputs, output):
            if active[0]:
                before = layout.of_tree(inputs)
                new = {k: v for k, v in layout.of_tree(output).items()
                       if k not in before}
                if new:
                    events.append({"module": f"{name} "
                                   f"({type(mod).__name__})", "copies": new})
        return fn
    return [m.register_forward_hook(hook(n)) for n, m in
            net.named_modules()]


def scan_products(dev, sizes, seed=0) -> dict:
    """The three batched products of ``physics.inertia.assemble_qM`` on the
    twin's shapes, each input 16 random envs tiled to every batch size of
    ``sizes``: {size: {product: [copies whose bits differ from copy 0]}}."""
    from vnl_tpu_torch import compat
    m = compat.model_from_numpy(compat.TWIN_MODEL, device=dev)
    sub = m.table("body_subtree_mask", torch.float32)
    g = torch.Generator(device=dev).manual_seed(seed)

    def copies(shape, b):
        x = torch.randn((16,) + shape, generator=g, device=dev)
        return x.repeat((b // 16,) + (1,) * len(shape))

    def parted(y, b):
        c = y.reshape(b // 16, 16, -1)
        return (c != c[:1]).flatten(1).any(1).nonzero().flatten().tolist()

    out = {}
    for b in sizes:
        cinert = copies((m.nbody, 36), b)
        crb = copies((m.nv, 6, 6), b)
        cdof = copies((m.nv, 6), b)
        f = copies((m.nv, 6), b)
        out[b] = {
            "einsum bc,nck->nbk (subtree sums)": parted(
                torch.einsum("bc,nck->nbk", sub, cinert), b),
            "einsum nvij,nvj->nvi (F)": parted(
                torch.einsum("nvij,nvj->nvi", crb, cdof), b),
            "F @ cdof^T": parted(f @ cdof.transpose(1, 2), b)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="twin")
    p.add_argument("--stage", default="unfused", choices=("fused",
                                                          "unfused"))
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--tries", type=int, default=3,
                   help="replays of the step that parts the copies")
    p.add_argument("--device", default="cuda",
                   help="cpu: a rehearsal of the script at a small batch")
    p.add_argument("--products", default="",
                   help="batch sizes (e.g. 1024,2048): only scan the "
                        "batched products of assemble_qM at each")
    args = p.parse_args(argv)
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("find_copy_divergence: needs a CUDA device", file=sys.stderr)
        return 1
    from vnl_tpu_torch.physics.forward import pin_fp32
    pin_fp32()
    if args.products:
        sizes = [int(x) for x in args.products.split(",")]
        print(json.dumps({"copy_divergence_products": scan_products(
            dev, sizes)}), flush=True)
        return 0
    from vnl_tpu_torch import check_numerics as cn, compat
    from vnl_tpu_torch.models import make_inference_fn
    names = [n for n in cn.ROLLOUTS
             if str(cn.load_golden(n)["scene"]) == args.scene]
    gs = {n: cn.load_golden(n) for n in names}
    n_envs = gs[names[0]]["qpos"].shape[1]
    n_steps = gs[names[0]]["qpos"].shape[0] - 1
    copies = max(1, args.batch // n_envs)
    per = copies * n_envs
    blocks = {n: slice(i * per, (i + 1) * per) for i, n in enumerate(names)}
    layout = Layout(per * len(names), blocks, copies, n_envs)
    env = cn.make_env(args.scene, dev, args.stage == "fused")

    def tile(x):
        return torch.as_tensor(np.tile(np.asarray(x)[:n_envs], (copies,) + (
            1,) * (np.ndim(x) - 1)), device=dev)

    kw = {"start_frame": torch.cat([tile(gs[n]["start_frame"])
                                    for n in names]).long()}
    if "noise" in gs[names[0]]:
        kw["noise"] = torch.cat([tile(gs[n]["noise"]) for n in names])
    net = compat.policy_from_numpy(compat.KEEPER_POLICY, device=dev)
    policy = make_inference_fn(net)(deterministic=True)

    def act(state, t):
        out = []
        for n in names:
            g, b = gs[n], blocks[n]
            out.append(policy(state.info["traj"][b], state.obs[b],
                              latent_noise=tile(g["latent_noise"][t]))[0]
                       if "latent_noise" in g else tile(g["actions"][t]))
        return torch.cat(out)

    events, active = [], [False]
    restore = wrap_all(layout, events, active)
    hooks = hook_modules(net, layout, events, active)

    def watched(fn):
        """fn() with every wrapper and hook on: (result, events)."""
        events.clear()
        active[0] = True
        try:
            return fn(), list(events)
        finally:
            active[0] = False

    state, ev = watched(lambda: env.reset(layout.batch, **kw))
    report = {"scene": args.scene, "stage": args.stage,
              "envs": layout.batch,
              "reset": {"parted": layout.of_tree(state),
                        "innermost_first": ev[:12]},
              "first_step": None, "tries": []}
    for t in range(n_steps):
        prev = state
        action, ev_act = watched(lambda: act(prev, t))
        state, ev = watched(lambda: env.step(prev, action))
        parted = layout.of_tree(state)
        if not parted:
            continue
        report["first_step"] = t + 1
        report["parted_action"] = layout.differing(action)
        report["parted_after_step"] = parted
        report["tries"].append({"action": ev_act[:12],
                                "innermost_first": ev[:12]})
        for _ in range(args.tries - 1):
            again, ev = watched(lambda: env.step(prev, action))
            report["tries"].append({"parted": layout.of_tree(again),
                                    "innermost_first": ev[:12]})
        break
    for h in hooks:
        h.remove()
    restore()
    print(json.dumps({"copy_divergence": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
