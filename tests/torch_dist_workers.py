"""Worker processes of tests/test_torch_parallel.py: each joins a gloo
process group on localhost, runs the port's collectives or its
data-parallel trainer on the CPU, and writes what it got to
``<out_dir>/rank<r>.npz`` and ``.json``.  Imports nothing of JAX."""

import copy
import functools
import json
import os

import numpy as np
import torch
import torch.distributed as dist


def _join(rank, world, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)


def _write(out_dir, rank, arrays, record):
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def collectives(rank, world, port, data_path, out_dir):
    """The normaliser update and the gradient mean on this rank's share of
    the data; assert_is_replicated on equal and on differing leaves;
    synchronize_hosts; create_mesh."""
    from vnl_tpu_torch.parallel import mesh
    from vnl_tpu_torch.training import gradients, running_statistics
    _join(rank, world, port)
    try:
        z = np.load(data_path)
        obs = torch.as_tensor(z["obs"])
        n = obs.shape[0] // world
        st = running_statistics.init_state(obs.shape[-1:], device="cpu")
        st = running_statistics.update(st, obs[rank * n:(rank + 1) * n],
                                       data_parallel=True)

        x = torch.as_tensor(z["x"])
        m = x.shape[0] // world
        mine = x[rank * m:(rank + 1) * m]
        lin = torch.nn.Linear(x.shape[1], z["w"].shape[1])
        with torch.no_grad():
            lin.weight.copy_(torch.as_tensor(z["w"].T))
            lin.bias.copy_(torch.as_tensor(z["b"]))
        (lin(mine) ** 2).mean().backward()
        gradients.all_reduce_gradients(lin.parameters())
        grads = [p.grad.clone() for p in lin.parameters()]
        opt = torch.optim.SGD(lin.parameters(), lr=1.0)
        step = gradients.gradient_update_fn(
            lambda v: (lin(v) ** 2).mean(), opt, data_parallel=True)
        before = [p.detach().clone() for p in lin.parameters()]
        step(mine)

        tree = {"a": torch.arange(5.0), "b": {"c": torch.ones(2, 3)},
                "n": 7, "stats": st}
        mesh.assert_is_replicated(tree)
        bad = copy.deepcopy(tree)
        if rank == 1:
            bad["b"]["c"][0, 1] += 1.0
        try:
            mesh.assert_is_replicated(bad, debug="on purpose")
            message = None
        except AssertionError as e:
            message = str(e)
        mesh.synchronize_hosts()
        dmesh = mesh.create_mesh()
        try:
            mesh.create_mesh(num_devices=world + 1)
            wrong_size = None
        except ValueError as e:
            wrong_size = str(e)
        sharded, replicated = mesh.data_parallel_specs()
        _write(out_dir, rank, dict(
            count=st.count.numpy(), mean=st.mean.numpy(),
            summed_variance=st.summed_variance.numpy(), std=st.std.numpy(),
            grad_w=grads[0].numpy(), grad_b=grads[1].numpy(),
            step_w=(before[0] - lin.weight.detach()).numpy(),
            step_b=(before[1] - lin.bias.detach()).numpy()), dict(
            message=message, wrong_size=wrong_size,
            mesh_dims=list(dmesh.mesh_dim_names), mesh_size=dmesh.size(),
            specs=[type(sharded).__name__, sharded.dim,
                   type(replicated).__name__],
            counts=dict(mesh.collective_counts)))
    finally:
        dist.destroy_process_group()


def tiny_training(rank, world, port, out_dir):
    """train(num_devices=world) on the twin at the CPU tests' tiny sizes:
    4 envs in all, narrow networks, the unfused position stage."""
    from vnl_tpu_torch import models
    from vnl_tpu_torch.envs import make_twin_env
    from vnl_tpu_torch.parallel import mesh
    from vnl_tpu_torch.training import train
    _join(rank, world, port)
    try:
        env = make_twin_env(device="cpu", fused_position=False,
                            physics_steps_per_control_step=2)
        factory = functools.partial(
            models.make_intention_ppo_networks, intention_latent_size=8,
            encoder_layer_sizes=(32,), decoder_layer_sizes=(32,),
            value_hidden_layer_sizes=(32,))
        progress = []
        mesh.reset_collective_counts()
        _, (norm, policy), metrics = train(
            env, num_timesteps=32, episode_length=6, num_envs=4,
            num_eval_envs=2, unroll_length=4, batch_size=2,
            num_minibatches=2, num_updates_per_batch=2, num_evals=2,
            normalize_observations=True, network_factory=factory,
            progress_fn=lambda step, m: progress.append(step),
            device="cpu", num_devices=world)
        arrays = {f"policy.{k}": v.numpy() for k, v in policy.items()}
        arrays.update({f"normalizer.{k}": getattr(norm, k).numpy()
                       for k in ("count", "mean", "summed_variance", "std")})
        _write(out_dir, rank, arrays, dict(
            metrics={k: float(v) for k, v in metrics.items()},
            progress=progress, counts=dict(mesh.collective_counts)))
    finally:
        dist.destroy_process_group()
