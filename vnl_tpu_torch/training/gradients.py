"""Gradient update (PyTorch counterpart of vnl_tpu/training/gradients.py):
loss, backward, the gradient mean over the ranks of a process group (the
JAX package's pmean over the mesh axis), and one optimizer step.

The optimizer is the port's own Adam, written on ``torch._foreach_*``
with its step count on the parameters' device, so that an update can be
captured in a CUDA graph (the JAX package jits it inside its scans,
training/train.py:234-284); ``torch.optim.Adam`` keeps its step count on
the host, and its ``capturable=True`` refuses CPU parameters."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Mapping, Sequence

import torch

from vnl_tpu_torch.utils import graphs


# the largest subnormal float32: Adam flushes moments of this size or less
SUBNORMAL_MAX = 1.1754942106924411e-38
# the elements between the starts of two moments in Adam's buffer
ALIGN = 128


class Adam:
    """optax.adam's rule: b1 0.9, b2 0.999, eps 1e-8 added outside the
    square root, bias-corrected moments, ``p - lr mu_hat / (sqrt(nu_hat) +
    eps)``.  The step count ``count`` (optax's ``count``) is a float32
    tensor on the parameters' device and the bias corrections ``1 -
    b**count`` are taken in float32, as optax takes them, so one update
    runs the same on the CPU and in a CUDA graph.  A parameter without a
    gradient is left alone, as torch.optim.Adam leaves it.  The moments
    ``exp_avg`` / ``exp_avg_sq`` (optax's mu / nu, one a parameter, views
    of one buffer) and ``count`` are written in place by every update.

    ``flush`` sets the moments' subnormal entries to 0, as the TPU
    flushes them; the trainer calls it once a training step.  Where a
    gradient stays exactly 0 (a dead unit), mu decays by b1 an update into
    the subnormals and stops there a few ulp above 0, and the card divides
    a subnormal on a slow path, so the updates slow as such entries
    gather.  No parameter moves for it: a subnormal moment's share of an
    update is below 1e-33."""

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
        if len({(p.dtype, p.device) for p in self.params}) != 1:
            raise ValueError(
                "Adam's parameters must share one dtype and device")
        # both moments in one buffer, which one launch flushes; each view
        # starts 512 bytes in, as the caching allocator's blocks do, so
        # that the foreach kernels take their vectorised path
        at, starts = 0, []
        for p in self.params * 2:
            starts.append(at)
            at += -(-p.numel() // ALIGN) * ALIGN
        self._moments = self.params[0].new_zeros(at)
        views = [self._moments[s:s + p.numel()].view(p.shape)
                 for s, p in zip(starts, self.params * 2)]
        self.exp_avg = views[:len(self.params)]
        self.exp_avg_sq = views[len(self.params):]

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

    @torch.no_grad()
    def flush(self) -> None:
        """Sets the moments' subnormal entries to 0, in one launch."""
        torch.hardshrink(self._moments, SUBNORMAL_MAX, out=self._moments)


def make_adam(params: Iterable[torch.nn.Parameter],
              learning_rate: float) -> Adam:
    """Adam by optax.adam's rule and defaults."""
    return Adam(params, learning_rate)


def _index(optimizer: Adam) -> Dict[torch.nn.Parameter, int]:
    return {p: i for i, p in enumerate(optimizer.params)}


def adam_state(optimizer: Adam,
               named_parameters: Mapping[str, torch.nn.Parameter]) -> Dict:
    """Adam's state by parameter name: ``step`` (optax's ``count``) and
    the moments ``exp_avg`` / ``exp_avg_sq`` (optax's ``mu`` / ``nu``).
    The moments are the optimizer's own tensors, updated in place by later
    steps; before the first step they are zeros."""
    index = _index(optimizer)
    return {"step": int(optimizer.count),
            "exp_avg": {name: optimizer.exp_avg[index[p]]
                        for name, p in named_parameters.items()},
            "exp_avg_sq": {name: optimizer.exp_avg_sq[index[p]]
                           for name, p in named_parameters.items()}}


def load_adam_state(optimizer: Adam,
                    named_parameters: Mapping[str, torch.nn.Parameter],
                    state: Mapping) -> None:
    """Writes ``state`` (as :func:`adam_state` returns it) into the
    optimizer's tensors in place, so its next step is step ``state["step"]
    + 1`` and a captured update reads it."""
    index = _index(optimizer)
    with torch.no_grad():
        optimizer.count.fill_(float(state["step"]))
        for name, p in named_parameters.items():
            i = index[p]
            optimizer.exp_avg[i].copy_(state["exp_avg"][name])
            optimizer.exp_avg_sq[i].copy_(state["exp_avg_sq"][name])


def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replaces each parameter's gradient by its mean over the ranks of the
    process group, by one all-reduce of all of them (in place)."""
    from vnl_tpu_torch.parallel import mesh
    grads = [p.grad for p in params if p.grad is not None]
    # one launch each: the concatenation, the all-reduce, the division and
    # the copy back
    torch._foreach_copy_(grads, mesh.all_reduce_mean(
        grads, name="grad_all_reduce"))


def gradient_update_fn(loss_fn: Callable, optimizer,
                       has_aux: bool = False, data_parallel: bool = False,
                       cuda_graph: bool = False,
                       generators: Sequence[torch.Generator] = ()):
    """Returns f(*args, **kwargs): evaluates ``loss_fn``, backpropagates,
    with ``data_parallel`` averages the gradients over the ranks of the
    process group, and applies one ``optimizer`` step (``Adam``, or a
    torch optimizer) to the parameters it holds (in place).  Returns what
    ``loss_fn`` returned: the loss, or (loss, aux).

    With ``cuda_graph`` the update is one CUDA graph replay: f(minibatch)
    takes one nest of CUDA tensors, which it copies into the static
    minibatch the graph reads (one ``torch._foreach_copy_``), and returns
    the loss and aux (a dict of scalar tensors) copied out of the graph's
    outputs in one launch, without an autograd graph.  The first call runs
    eagerly on a side stream (the warm-up, a real update) and captures the
    graph after it; ``generators`` are those ``loss_fn`` draws from."""

    params = (optimizer.params if isinstance(optimizer, Adam) else
              [p for group in optimizer.param_groups for p in group["params"]])

    def f(*args, **kwargs):
        optimizer.zero_grad()
        out = loss_fn(*args, **kwargs)
        (out[0] if has_aux else out).backward()
        if data_parallel:
            all_reduce_gradients(params)
        optimizer.step()
        return out

    if not cuda_graph:
        return f

    def packed(minibatch) -> torch.Tensor:
        loss, aux = f(minibatch) if has_aux else (f(minibatch), {})
        return torch.stack([loss.detach()] + [aux[k] for k in sorted(aux)])

    captured = {}

    def graphed(minibatch):
        if not captured:
            graphs.require_cuda(minibatch, "the SGD-update graph")
            out = graphs.warm_up(f, minibatch)
            # without the warm-up's autograd graph, whose gradient
            # accumulators belong to the side stream
            out = (out[0].detach(), out[1]) if has_aux else out.detach()
            static = graphs.clone(minibatch)
            captured["graph"] = graphs.Graph(packed, (static,),
                                             name="sgd_update",
                                             generators=generators)
            captured["names"] = sorted(out[1]) if has_aux else []
            return out
        graph = captured["graph"]
        graphs.copy_(graph.args[0], minibatch)
        flat = graph.replay().clone()
        if not has_aux:
            return flat[0]
        return flat[0], {k: flat[i + 1]
                         for i, k in enumerate(captured["names"])}

    return graphed
