"""Gradient update (PyTorch counterpart of vnl_tpu/training/gradients.py):
loss, backward, the gradient mean over the ranks of a process group (the
JAX package's pmean over the mesh axis), and one optimizer step."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping

import torch


def make_adam(params: Iterable[torch.nn.Parameter],
              learning_rate: float) -> torch.optim.Adam:
    """Adam by optax.adam's rule and defaults: b1 0.9, b2 0.999, eps 1e-8
    added outside the square root, bias-corrected moments."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def adam_state(optimizer: torch.optim.Adam,
               named_parameters: Mapping[str, torch.nn.Parameter]) -> Dict:
    """Adam's state by parameter name: ``step`` (optax's ``count``) and
    the moments ``exp_avg`` / ``exp_avg_sq`` (optax's ``mu`` / ``nu``).
    The moments are the optimizer's own tensors, updated in place by later
    steps; before the first step they are zeros."""
    out = {"step": 0, "exp_avg": {}, "exp_avg_sq": {}}
    for name, p in named_parameters.items():
        st = optimizer.state.get(p, {})
        if st:
            out["step"] = int(st["step"])
        for k in ("exp_avg", "exp_avg_sq"):
            out[k][name] = st[k] if st else torch.zeros_like(p)
    return out


def load_adam_state(optimizer: torch.optim.Adam,
                    named_parameters: Mapping[str, torch.nn.Parameter],
                    state: Mapping) -> None:
    """Makes ``state`` (as :func:`adam_state` returns it) the optimizer's,
    so its next step is step ``state["step"] + 1``."""
    for name, p in named_parameters.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(state["step"]), dtype=torch.float32),
            "exp_avg": state["exp_avg"][name].to(p).clone(),
            "exp_avg_sq": state["exp_avg_sq"][name].to(p).clone()}


def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replaces each parameter's gradient by its mean over the ranks of the
    process group, by one all-reduce of all of them (in place)."""
    from vnl_tpu_torch.parallel import mesh
    grads = [p.grad for p in params if p.grad is not None]
    # one launch each: the concatenation, the all-reduce, the division and
    # the copy back (an SGD update is host-bound; PERF.md §5)
    torch._foreach_copy_(grads, mesh.all_reduce_mean(
        grads, name="grad_all_reduce"))


def gradient_update_fn(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                       has_aux: bool = False, data_parallel: bool = False):
    """Returns f(*args, **kwargs): evaluates ``loss_fn``, backpropagates,
    with ``data_parallel`` averages the gradients over the ranks of the
    process group, and applies one ``optimizer`` step to the parameters it
    holds (in place).  Returns what ``loss_fn`` returned: the loss, or
    (loss, aux)."""

    def f(*args, **kwargs):
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(*args, **kwargs)
        (out[0] if has_aux else out).backward()
        if data_parallel:
            all_reduce_gradients(p for group in optimizer.param_groups
                                 for p in group["params"])
        optimizer.step()
        return out

    return f
