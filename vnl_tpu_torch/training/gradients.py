"""Gradient update (PyTorch counterpart of vnl_tpu/training/gradients.py):
loss, backward and one optimizer step.  The cross-device gradient mean of
the JAX package is not ported yet."""

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


def gradient_update_fn(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                       has_aux: bool = False):
    """Returns f(*args, **kwargs): evaluates ``loss_fn``, backpropagates
    and applies one ``optimizer`` step to the parameters it holds (in
    place).  Returns what ``loss_fn`` returned: the loss, or (loss, aux)."""

    def f(*args, **kwargs):
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(*args, **kwargs)
        (out[0] if has_aux else out).backward()
        optimizer.step()
        return out

    return f
