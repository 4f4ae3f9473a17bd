# -*- coding: utf-8 -*-
"""Process groups of the port (counterpart of
``gaussiancity_tpu/parallel/mesh.py``; upstream utils/distributed.py:
22-109).

One process is one rank on one device.  ``init_dist`` is the command
line's rendezvous (a ``TCPStore`` at ``host:port``); ``init_group`` takes
any store (the tests' ``FileStore``).  The backend is chosen once, before
the first collective, from where the ranks run, and logged:

- gloo when the ranks run on the CPU;
- NCCL when every rank has a card of its own;
- gloo when ranks share a card, which NCCL refuses: its collectives on
  CUDA tensors are staged through host memory.

Each rank publishes (host, device) to the store and reads every other
rank's before ``init_process_group``, so the choice needs no collective
and is never made by catching a failed one.
"""

from __future__ import annotations

import logging
import socket
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist

from gaussiancity_tpu_torch.device import resolve_device

TIMEOUT = timedelta(minutes=10)
_KEY = "gaussiancity/rank_device/{}"


def rank_device(process_id: int, device: Optional[Union[str, torch.device]]
                = None) -> torch.device:
    """The device of rank ``process_id``: ``cuda:(process_id % cards)``,
    or the CPU when ``device`` asks for it."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", process_id % torch.cuda.device_count())


def choose_backend(store, rank: int, world_size: int,
                   device: torch.device) -> str:
    """Publish this rank's (host, device) to ``store``, read every rank's,
    and name the backend: gloo on the CPU or where two ranks share a card,
    NCCL where every rank has its own."""
    me = f"{socket.gethostname()}/{device}"
    store.set(_KEY.format(rank), me)
    seen = [store.get(_KEY.format(r)).decode() for r in range(world_size)]
    if device.type != "cuda":
        return "gloo"
    return "nccl" if len(set(seen)) == world_size else "gloo"


def init_group(store, rank: int, world_size: int, device: torch.device
               ) -> str:
    """Join the default process group through ``store`` as ``rank`` of
    ``world_size`` on ``device``; returns the backend chosen."""
    backend = choose_backend(store, rank, world_size, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    logging.info("rank %d of %d on %s: backend %s", rank, world_size,
                 device, backend)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return backend


def init_dist(coordinator: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None
              ) -> torch.device:
    """Rendezvous of ``num_processes`` processes at ``coordinator``
    (``host:port``; rank 0 serves the store there), in place of upstream's
    ``init_process_group("nccl")``.  Returns this rank's device.  For one
    process it only resolves ``device``."""
    if not num_processes or num_processes <= 1:
        return resolve_device(device)
    if coordinator is None or process_id is None:
        raise ValueError("several processes need --coordinator host:port "
                         "and --process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in "
                         f"[0, {num_processes})")
    host, port = coordinator.rsplit(":", 1)
    dev = rank_device(process_id, device)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=TIMEOUT)
    init_group(store, process_id, num_processes, dev)
    return dev


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_master() -> bool:
    return get_rank() == 0


def make_data_mesh(data_axis: int = -1, tile_axis: int = 1):
    """A ``DeviceMesh`` of the ranks with dims ("data", "tile"), as the
    JAX mesh names its axes: ``mesh.get_group("data")`` is the group of
    the data-parallel step, ``mesh.get_group("tile")`` that of the
    band-sharded rasterizer."""
    from torch.distributed.device_mesh import init_device_mesh

    n = get_world_size()
    if data_axis == -1:
        if n % tile_axis:
            raise ValueError(f"{n} ranks do not divide into tiles of "
                             f"{tile_axis}")
        data_axis = n // tile_axis
    if data_axis * tile_axis != n:
        raise ValueError(f"mesh {data_axis}x{tile_axis} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data_axis, tile_axis),
                            mesh_dim_names=("data", "tile"))


def make_simple_mesh():
    """A one-dim ``DeviceMesh`` of every rank, named "data"."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (get_world_size(),),
                            mesh_dim_names=("data",))


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[n, ...] on each rank of ``group`` -> [world * n, ...] on every
    rank, rank r's rows at ``r * n``.  NCCL, and gloo on the CPU, gather;
    gloo gathers no CUDA tensors, so there each rank writes its rows into
    a zero-filled slab and the slabs are summed (x + 0 is x: the rows
    arrive unchanged)."""
    world = dist.get_world_size(group)
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        rank = dist.get_rank(group)
        n = x.shape[0]
        out = x.new_zeros((world * n, *x.shape[1:]))
        out[rank * n:(rank + 1) * n] = x
        dist.all_reduce(out, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)
