"""Gradient update (PyTorch counterpart of vnl_tpu/training/gradients.py):
loss, backward, the gradient mean over the ranks of a process group (the
JAX package's pmean over the mesh axis), and one optimizer step.

The optimizer is the port's own Adam, written on ``torch._foreach_*``
with its step count on the parameters' device, so that an update can be
captured in a CUDA graph (the JAX package jits it inside its scans,
training/train.py:234-284); ``torch.optim.Adam`` keeps its step count on
the host, and its ``capturable=True`` refuses CPU parameters."""

from __future__ import annotations

from typing import Iterable, List

import torch



class Adam:
    """optax.adam's rule: b1 0.9, b2 0.999, eps 1e-8 added outside the
    square root, bias-corrected moments, ``p - lr mu_hat / (sqrt(nu_hat) +
    eps)``.  The step count ``count`` (optax's ``count``) is a float32
    tensor on the parameters' device and the bias corrections ``1 -
    b**count`` are taken in float32, as optax takes them, so one update
    runs the same on the CPU and in a CUDA graph.  A parameter without a
    gradient is left alone, as torch.optim.Adam leaves it.  The moments
    ``exp_avg`` / ``exp_avg_sq`` (optax's mu / nu, one a parameter) and
    ``count`` are written in place by every update."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params: List[torch.nn.Parameter] = list(params)
        if not self.params:
            raise ValueError("Adam needs at least one parameter")
        self.learning_rate, self.b1, self.b2, self.eps = (
            learning_rate, b1, b2, eps)
        self.count = torch.zeros((), dtype=torch.float32,
                                 device=self.params[0].device)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        if not live:
            return
        params = [self.params[i] for i in live]
        grads = [p.grad for p in params]
        mu = [self.exp_avg[i] for i in live]
        nu = [self.exp_avg_sq[i] for i in live]
        b1, b2 = self.b1, self.b2
        self.count.add_(1.0)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(b1, self.count))
        denom = torch._foreach_sqrt(
            torch._foreach_div(nu, 1.0 - torch.pow(b2, self.count)))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_add_(params, torch._foreach_div(mu_hat, denom),
                            alpha=-self.learning_rate)
