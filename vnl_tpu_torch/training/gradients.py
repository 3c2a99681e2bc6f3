"""Gradient update (PyTorch counterpart of vnl_tpu/training/gradients.py):
loss, backward and one optimizer step.  The cross-device gradient mean of
the JAX package is not ported yet."""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def make_adam(params: Iterable[torch.nn.Parameter],
              learning_rate: float) -> torch.optim.Adam:
    """Adam by optax.adam's rule and defaults: b1 0.9, b2 0.999, eps 1e-8
    added outside the square root, bias-corrected moments."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


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
