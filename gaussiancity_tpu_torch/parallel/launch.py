# -*- coding: utf-8 -*-
"""Run a function on several ranks, one process each, from one parent:
the tests' and the smoke script's two-rank runs.

``spawn_ranks(fn, world, store_path, ...)`` starts ``world`` processes
with the ``spawn`` start method (a parent with CUDA initialised cannot
``fork``), joins them through a ``FileStore`` at ``store_path`` (no TCP
port, so that runs side by side cannot collide), calls ``fn(rank, world,
device, *args)`` in each and returns each rank's result.  Each process is
joined with a timeout: a rank that hangs or fails fails the call, and
the others are stopped.  ``fn`` must be importable by module path."""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch

from gaussiancity_tpu_torch.device import resolve_device


def _rank_main(fn, rank: int, world: int, store_path: str, device: str,
               args: tuple, out_path: str) -> None:
    import torch.distributed as dist

    from gaussiancity_tpu_torch.parallel import mesh

    dev = mesh.rank_device(rank, device)
    mesh.init_group(dist.FileStore(store_path, world), rank, world, dev)
    try:
        result = fn(rank, world, dev, *args)
        torch.save(result, out_path)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, store_path: str,
                args: Sequence = (), device: Optional[str] = None,
                timeout_s: float = 300.0) -> List:
    """``fn(rank, world, device, *args)`` on ``world`` spawned ranks; the
    list of their results, by rank.  Rank r runs on ``cuda:(r % cards)``
    unless ``device`` asks for the CPU; without a card and without that
    request this raises before it starts a process."""
    import torch.multiprocessing as mp

    device = resolve_device(device).type

    ctx = mp.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="ranks_",
                               dir=os.path.dirname(store_path) or None)
    outs = [os.path.join(out_dir, f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, store_path, device, tuple(args), outs[r]),
        daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running "
                               f"after {timeout_s:.0f} s")
        failed = {r: p.exitcode for r, p in enumerate(procs)
                  if p.exitcode != 0}
        if failed:
            raise RuntimeError(f"ranks failed with exit codes {failed}")
        return [torch.load(o, weights_only=False) for o in outs]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        for o in outs:
            if os.path.exists(o):
                os.unlink(o)
        os.rmdir(out_dir)
