"""Multi-process set-up: ``torch.distributed`` init and the host-aware
(data, map) mesh (counterpart of ``dcreg_tpu/parallel/distributed.py``).

One process per device.  The map axis, whose all_gather moves real
candidate bytes every iteration, stays inside one host (NVLink); the data
axis, whose per-iteration all-reduce moves 47 floats, spans hosts.  A
host is a run of ``LOCAL_WORLD_SIZE`` consecutive ranks, as ``torchrun``
numbers them.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .sharded import Mesh, make_mesh


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None,
                     backend: str | None = None) -> bool:
    """Initialize the default process group; returns True when more than
    one process takes part.

    ``init_method`` ("tcp://host:port", "file://...") with ``world_size``
    and ``rank``; left None, they come from the environment ``torchrun``
    sets (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK), and a lone process
    with none of them gets a one-rank world over an in-process store.
    ``backend`` defaults to NCCL where CUDA is available and gloo
    elsewhere.  A second call returns the live world's answer."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world_size > 1:
            raise ValueError(f"a world of {world_size} processes needs "
                             "init_method or MASTER_ADDR/MASTER_PORT")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    return dist.get_world_size() > 1


def make_host_mesh(map_per_host: int | None = None, device=None) -> Mesh:
    """(data, map) mesh over all ranks with the map axis inside a host.

    ``map_per_host`` defaults to the largest of 3 and 2 that divides the
    host's rank count (``LOCAL_WORLD_SIZE``, else the whole world), else
    1.  ``device`` as ``make_mesh``."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if map_per_host is None:
        map_per_host = next((f for f in (3, 2) if local % f == 0), 1)
    if local % map_per_host:
        raise ValueError(f"map_per_host {map_per_host} does not divide the "
                         f"{local} ranks of a host")
    return make_mesh(world // map_per_host, map_per_host, device=device)
