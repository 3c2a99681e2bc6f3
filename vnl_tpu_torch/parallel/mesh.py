"""Device mesh and collectives of the data-parallel trainer (PyTorch
counterpart of vnl_tpu/parallel/mesh.py).

One process per GPU: each process is one shard of the data axis, holds
its own envs and a replica of the networks, and the collectives are
explicit: the gradient mean and the normaliser's sums are all-reduces over
the default process group.  The JAX package's ``shard_map_fn`` has no
counterpart, since no program here is mapped over devices.  Each
collective helper adds one to ``collective_counts`` under its name when it
launches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

collective_counts: Dict[str, int] = {}


def reset_collective_counts() -> None:
    collective_counts.clear()


def _count(name: str) -> None:
    collective_counts[name] = collective_counts.get(name, 0) + 1


def process_group():
    """The default process group when one is initialised, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def world_size() -> int:
    return dist.get_world_size() if process_group() is not None else 1


def rank() -> int:
    return dist.get_rank() if process_group() is not None else 0


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _group_device() -> torch.device:
    """Where the group's collectives take their tensors."""
    if _device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def create_mesh(num_devices: Optional[int] = None,
                axis_name: str = "data"):
    """A flat data-parallel ``DeviceMesh`` over every process of the
    initialised group (one GPU each), with the one axis ``axis_name``.
    ``num_devices``, when given, must be the group's size."""
    from torch.distributed.device_mesh import init_device_mesh
    if process_group() is None:
        raise RuntimeError("create_mesh needs an initialised process group "
                           "(parallel.initialize)")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices}, but the process group "
                         f"has {world} processes (one a device)")
    return init_device_mesh(_device_type(), (world,),
                            mesh_dim_names=(axis_name,))


def data_parallel_specs():
    """(sharded, replicated) placements of a flat data-parallel mesh."""
    from torch.distributed.tensor import Replicate, Shard
    return Shard(0), Replicate()


def all_reduce_sum(tensors: Sequence[torch.Tensor], name: str = "all_reduce",
                   mean: bool = False) -> List[torch.Tensor]:
    """Each tensor (one dtype) summed over the ranks (``jax.lax.psum``), or
    with ``mean`` averaged (``jax.lax.pmean``): one all-reduce of their
    concatenation, counted under ``name``.  Returns views of one buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dev = flat.device
    buf = flat.to(_group_device())
    dist.all_reduce(buf)
    _count(name)
    if mean:
        buf.div_(dist.get_world_size())
    buf = buf.to(dev)
    out, at = [], 0
    for t in tensors:
        out.append(buf[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def all_reduce_mean(tensors: Sequence[torch.Tensor],
                    name: str = "all_reduce") -> List[torch.Tensor]:
    """Each tensor averaged over the ranks (``jax.lax.pmean``)."""
    return all_reduce_sum(tensors, name, mean=True)


def _leaves(x, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor or number in a nest of dicts,
    lists, tuples and dataclasses."""
    if torch.is_tensor(x):
        yield path, x
    elif isinstance(x, (int, float)):
        yield path, torch.tensor(x)
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{path}.{f.name}")


def assert_is_replicated(x, debug=None) -> None:
    """Checks that every tensor (and number) of the nest ``x`` holds the
    same bits on every rank of the group: one all-gather of all leaves'
    bytes, each rank's held against rank 0's.  Raises AssertionError naming
    the first leaf that differs.  Without a process group there is one
    replica and nothing to check."""
    if process_group() is None:
        return
    leaves = list(_leaves(x))
    dev = _group_device()
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8).to(dev)
            for _, t in leaves]
    buf = torch.cat(flat) if flat else torch.zeros(0, dtype=torch.uint8,
                                                   device=dev)
    world = dist.get_world_size()
    sizes = [torch.zeros(1, dtype=torch.int64, device=dev)
             for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([buf.numel()], device=dev))
    _count("all_gather")
    suffix = f"; {debug}" if debug else ""
    if len({int(s) for s in sizes}) != 1:
        raise AssertionError(f"the ranks hold {[int(s) for s in sizes]} "
                             f"bytes of leaves{suffix}")
    gathered = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(gathered, buf)
    _count("all_gather")
    ends = torch.cumsum(torch.tensor([f.numel() for f in flat]), 0)
    for r in range(1, world):
        diff = torch.nonzero(gathered[r] != gathered[0])
        if diff.numel():
            i = int(torch.searchsorted(ends, int(diff[0, 0]), right=True))
            raise AssertionError(f"leaf {leaves[i][0]} differs between rank "
                                 f"0 and rank {r}{suffix}")


def synchronize_hosts() -> None:
    """Barrier across the processes: an all-reduce of ones over the group,
    whose sum must be the group's size.  Without a group, nothing."""
    if process_group() is None:
        return
    ones = torch.ones(1, device=_group_device())
    dist.all_reduce(ones)
    _count("all_reduce")
    if int(ones.item()) != dist.get_world_size():
        raise AssertionError(f"synchronize_hosts: {int(ones.item())} of "
                             f"{dist.get_world_size()} processes")
