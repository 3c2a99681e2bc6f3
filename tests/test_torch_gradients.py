"""The optimiser step of vnl_tpu_torch against vnl_tpu's: make_adam
(torch.optim.Adam at optax.adam's defaults) on fixed gradients for three
updates against optax.adam, parameters at 1e-6; and gradient_update_fn on
a small quadratic loss against vnl_tpu.training.gradients.gradient_update_fn
for three updates, loss and parameters at 1e-6."""

import jax.numpy as jnp
import numpy as np
import optax
import torch

from vnl_tpu.training import gradients as jgradients
from vnl_tpu_torch.training import gradients as tgradients

LR = 6e-4


def _tensors(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.normal(size=(5, 3))).astype(np.float32),
            "b": (scale * rng.normal(size=(3,))).astype(np.float32)}


def test_adam_matches_optax_on_fixed_gradients():
    """Gradients spanning five orders of magnitude, so that eps outside the
    square root and the bias correction both show."""
    params = _tensors(0)
    grads = [_tensors(1 + k, scale=10.0 ** (k - 3)) for k in range(3)]
    grads[1]["b"][0] = 0.0

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt = optax.adam(optax.constant_schedule(LR))
    state = opt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params.items()}
    topt = tgradients.make_adam(tparams.values(), LR)

    for step, g in enumerate(grads):
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
            assert not np.array_equal(tparams[k].detach().numpy(), params[k])


def test_gradient_update_fn_matches():
    """loss(params, x) = mean((x w + b)^2) + sum |b|: value, aux and the
    updated parameters over three chained updates."""
    params = _tensors(5)
    xs = [np.random.default_rng(6 + k).normal(size=(4, 5)).astype(np.float32)
          for k in range(3)]

    def jloss(p, x):
        y = x @ p["w"] + p["b"]
        return jnp.mean(y ** 2) + jnp.sum(jnp.abs(p["b"])), {"y": y.mean()}

    opt = optax.adam(optax.constant_schedule(LR))
    jupdate = jgradients.gradient_update_fn(jloss, opt, axis_name=None,
                                            has_aux=True)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jparams)

    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params.items()}

    def tloss(x):
        y = x @ tparams["w"] + tparams["b"]
        return ((y ** 2).mean() + tparams["b"].abs().sum(),
                {"y": y.mean().detach()})

    tupdate = tgradients.gradient_update_fn(
        tloss, tgradients.make_adam(tparams.values(), LR), has_aux=True)

    for step, x in enumerate(xs):
        (jl, jaux), jparams, state = jupdate(jparams, jnp.asarray(x),
                                             optimizer_state=state)
        tl, taux = tupdate(torch.as_tensor(x))
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
        np.testing.assert_allclose(float(taux["y"]), float(jaux["y"]),
                                   rtol=1e-5, atol=1e-6)
        for k in params:
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), np.asarray(jparams[k]),
                rtol=1e-6, atol=1e-6, err_msg=f"{k} after update {step}")


def test_gradient_update_fn_without_aux():
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    update = tgradients.gradient_update_fn(
        lambda: (w ** 2).sum(), tgradients.make_adam([w], 0.1))
    first = float(update().detach())
    for _ in range(20):
        last = float(update().detach())
    assert last < first
