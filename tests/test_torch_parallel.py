"""The port's data parallelism on the CPU: two gloo processes on localhost
(a free port chosen at run time), each test with its own time limit.

- The normaliser update over the two ranks' shares of a batch equals
  vnl_tpu's running_statistics.update under shard_map with its psum on 2
  CPU devices, at 1e-6.
- The all-reduced gradient equals vnl_tpu's loss_and_pgrad pmean on the
  same 2-device mesh, at 1e-6; an SGD step through
  gradient_update_fn(data_parallel=True) moves the parameters by it.
- assert_is_replicated passes on equal leaves and raises on a leaf changed
  on purpose, naming it; synchronize_hosts and create_mesh run.
- A tiny twin training on the two ranks (4 envs, narrow networks, the
  unfused stage) ends with bit-identical params on both ranks, and rank 0
  alone holds the metrics.
"""

import json
import multiprocessing
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_dist_workers as workers
from vnl_tpu.parallel import mesh as jmesh
from vnl_tpu.training import gradients as jgradients
from vnl_tpu.training import running_statistics as jrs

WORLD = 2
TIMEOUT_S = 180


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(target, *args, out_dir):
    """Runs ``target(rank, WORLD, port, *args, out_dir)`` in WORLD spawned
    processes; returns each rank's (arrays, record)."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=target,
                         args=(r, WORLD, port) + args + (str(out_dir),))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT_S)
        assert not any(p.is_alive() for p in procs), "a rank timed out"
        assert [p.exitcode for p in procs] == [0] * WORLD
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    out = []
    for r in range(WORLD):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append((arrays, json.load(f)))
    return out


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)
    data = dict(obs=rng.normal(1.0, 2.0, (8, 3, 5)).astype(np.float32),
                x=rng.normal(size=(6, 4)).astype(np.float32),
                w=rng.normal(size=(4, 3)).astype(np.float32),
                b=rng.normal(size=3).astype(np.float32))
    path = str(d / "data.npz")
    np.savez(path, **data)
    return data, run_ranks(workers.collectives, path, out_dir=d)


def jax_mesh():
    return jmesh.create_mesh(WORLD)


def test_normalizer_update_equals_jax_psum(collectives):
    data, ranks = collectives
    mesh = jax_mesh()
    update = jmesh.shard_map_fn(
        lambda s, b: jrs.update(s, b, axis_name="data"), mesh,
        in_specs=(P(), P("data")), out_specs=P())
    want = jax.jit(update)(jrs.init_state((5,)), jnp.asarray(data["obs"]))
    for arrays, _ in ranks:
        for k in ("count", "mean", "summed_variance", "std"):
            np.testing.assert_allclose(arrays[k], np.asarray(getattr(want, k)),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("count", "mean", "summed_variance", "std"):
        assert np.array_equal(ranks[0][0][k], ranks[1][0][k]), k


def test_gradient_mean_equals_jax_pmean(collectives):
    data, ranks = collectives
    mesh = jax_mesh()

    def loss(params, x):
        return jnp.mean((x @ params["w"] + params["b"]) ** 2)

    pgrad = jgradients.loss_and_pgrad(loss, axis_name="data")
    grads = jax.jit(jmesh.shard_map_fn(
        lambda p, x: pgrad(p, x)[1], mesh, in_specs=(P(), P("data")),
        out_specs=P()))({"w": jnp.asarray(data["w"]),
                         "b": jnp.asarray(data["b"])}, jnp.asarray(data["x"]))
    for arrays, rec in ranks:
        np.testing.assert_allclose(arrays["grad_w"], np.asarray(grads["w"]).T,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(arrays["grad_b"], np.asarray(grads["b"]),
                                   rtol=1e-6, atol=1e-6)
        # the SGD step (lr 1) of gradient_update_fn moved by the mean
        np.testing.assert_allclose(arrays["step_w"], arrays["grad_w"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(arrays["step_b"], arrays["grad_b"],
                                   rtol=1e-6, atol=1e-6)
        assert rec["counts"]["grad_all_reduce"] == 2
        assert rec["counts"]["normalizer_all_reduce"] == 2
    assert np.array_equal(ranks[0][0]["grad_w"], ranks[1][0]["grad_w"])


def test_replication_check_barrier_and_mesh(collectives):
    _, ranks = collectives
    for _, rec in ranks:
        assert rec["message"] == ("leaf ['b']['c'] differs between rank 0 "
                                  "and rank 1; on purpose")
        assert "num_devices=3" in rec["wrong_size"]
        assert rec["mesh_dims"] == ["data"] and rec["mesh_size"] == WORLD
        assert rec["specs"] == ["Shard", 0, "Replicate"]
        # two checks of two gathers each, one barrier
        assert rec["counts"]["all_gather"] == 4
        assert rec["counts"]["all_reduce"] == 1


def test_two_rank_training_stays_replicated(tmp_path):
    ranks = run_ranks(workers.tiny_training, out_dir=tmp_path)
    (a0, r0), (a1, r1) = ranks
    assert sorted(a0) == sorted(a1) and any(k.startswith("policy.")
                                            for k in a0)
    for k in a0:
        assert a0[k].tobytes() == a1[k].tobytes(), k
    # the normaliser saw both ranks' rows: 2 steps x 2 rollouts' worth
    assert float(a0["normalizer.count"]) == 2 * 4 * 4
    assert r0["progress"] == [0, 32] and r1["progress"] == []
    assert np.isfinite(r0["metrics"]["training/total_loss"])
    assert "eval/episode_reward" in r0["metrics"] and r1["metrics"] == {}
    for rec in (r0, r1):
        # 2 steps x 2 passes x 2 minibatches, one all-reduce an update
        assert rec["counts"]["grad_all_reduce"] == 8
        assert rec["counts"]["normalizer_all_reduce"] == 4
        assert rec["counts"]["metrics_all_reduce"] == 1
