"""Multi-process initialisation (PyTorch counterpart of
vnl_tpu/parallel/distributed.py): one process per GPU, joined in one
``torch.distributed`` process group.  Call :func:`initialize` once per
process before training; the trainer then all-reduces gradients and the
normaliser over the group."""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> None:
    """``torch.distributed.init_process_group`` for this process: NCCL for
    a ``cuda`` device, gloo for ``cpu``.  A no-op for one process.

    The arguments default to what ``torch.distributed.run`` (torchrun)
    sets: ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.
    ``coordinator_address`` is ``host:port``.  An already initialised
    group is kept; any other failure raises."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        logging.info("torch.distributed already initialised: rank %d of %d",
                     dist.get_rank(), dist.get_world_size())
        return
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    logging.info("process %d of %d (%s)", dist.get_rank(),
                 dist.get_world_size(), backend)
