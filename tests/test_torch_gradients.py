"""The optimiser step of vnl_tpu_torch against vnl_tpu's: make_adam
(torch.optim.Adam at optax.adam's defaults) on fixed gradients for three
updates against optax.adam, parameters at 1e-6; and gradient_update_fn on
a small quadratic loss against vnl_tpu.training.gradients.gradient_update_fn
for three updates, loss and parameters at 1e-6; and the flush of subnormal
moments, against the same rule without it."""

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


def _adam_without_flush(params, grads, mu, nu, count, lr):
    """make_adam's update as it is written, less the flush of subnormal
    moments."""
    b1, b2 = 0.9, 0.999
    count.add_(1.0)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
    mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(b1, count))
    denom = torch._foreach_sqrt(
        torch._foreach_div(nu, 1.0 - torch.pow(b2, count)))
    torch._foreach_add_(denom, 1e-8)
    torch._foreach_add_(params, torch._foreach_div(mu_hat, denom),
                        alpha=-lr)


def test_adam_flushes_subnormal_moments_and_moves_no_parameter():
    """Entries whose gradient falls to exactly 0 (dead units) after 1-400
    updates, at scales 1e-6 to 1, and entries whose nu starts at the
    bottom of the normal range: over 1,200 updates, flushed every 64, the
    rule without the flush leaves mu and nu subnormal there, make_adam 0;
    the parameters stay bit for bit the same, and every moment that the
    rule leaves normal or 0 is the same."""
    tiny = torch.finfo(torch.float32).tiny
    gen = torch.Generator().manual_seed(5)
    shapes = [(64, 32), (32,)]
    params = [torch.nn.Parameter(torch.randn(s, generator=gen))
              for s in shapes]
    scale = [10.0 ** (-6 * torch.rand(s, generator=gen)) for s in shapes]
    dies = [torch.randint(1, 400, s, generator=gen) for s in shapes]
    ref = [p.detach().clone() for p in params]
    opt = tgradients.make_adam(params, LR)
    low = [torch.rand(s, generator=gen) < 0.1 for s in shapes]
    for n, m in zip(opt.exp_avg_sq, low):
        n[m] = tiny * 1.5
    mu = [m.clone() for m in opt.exp_avg]
    nu = [n.clone() for n in opt.exp_avg_sq]
    count = torch.zeros(())
    for t in range(1, 1201):
        grads = [torch.randn(s, generator=gen) * c * (d > t) * ~m
                 for s, c, d, m in zip(shapes, scale, dies, low)]
        for p, g in zip(params, grads):
            p.grad = g.clone()
        opt.step()
        if t % 64 == 0 or t == 1200:
            opt.flush()
        _adam_without_flush(ref, grads, mu, nu, count, LR)
    for p, r in zip(params, ref):
        assert p.detach().numpy().tobytes() == r.numpy().tobytes()
    for got, want in ((opt.exp_avg, mu), (opt.exp_avg_sq, nu)):
        assert sum(int(((w != 0) & (w.abs() < tiny)).sum())
                   for w in want) > 100
        for g, w in zip(got, want):
            normal = (w == 0) | (w.abs() >= tiny)
            assert torch.equal(g[normal], w[normal])
            assert not bool(((g != 0) & (g.abs() < tiny)).any())
            assert bool((g[~normal] == 0).all())

