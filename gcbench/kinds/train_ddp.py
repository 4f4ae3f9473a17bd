"""Data-parallel train-step cells: ``world`` ranks, one process and one
card each, started by the port's ``parallel.launch.spawn_ranks`` (NCCL
where every rank has a card of its own, gloo on the CPU), each a
``Trainer`` behind the port's ``make_parallel_train_step``.  At step i
rank r takes sample (world i + r) mod the traffic's samples, and draws
from (seed, i, r).

Set-up, in each rank: the samples, the trainer (rank 0 loads the
benchmark's weights; building the step broadcasts rank 0's state), the
first ``followed_steps`` steps, whose numbers rank 0 keeps as the train
kind does, and ``replicas``, the largest gap between any rank's weights
and running state and rank 0's after them.  Rank 0 then sets the
window's step count from the followed steps' time and ``--seconds`` and
broadcasts it, so that no step carries a collective of the harness's.
``train_step_ms`` is rank 0's time over the window, ended by a
synchronise and a barrier, over its steps.  Once the ranks have ended,
the parent follows the same steps with the reference
(``gcbench/reference/train_ddp.py``) on one device.

On the card a run stands only where every rank had a card of its own
and the group ran over NCCL: the port's launcher puts rank r on
``cuda:(r % cards)`` and falls back to gloo where ranks share a card,
and such a run measures another transport on fewer cards, so it ends
with no result.  ``mfu.train`` reads the reference's model FLOPs of a
step over the ranks, a card's share."""

from __future__ import annotations

import gc
import math
import os
import shutil
import statistics
import tempfile
import time
from typing import Dict, List

import torch

from gcbench import compare, devices, faults, inputs, precision, weights
from gcbench.harness import (HOST_THREADS, Context, forbidden_modules, log,
                             read_per_layer)
from gcbench.kinds.train import _Capture, _follow, follow_reference
from gcbench.reference.train_ddp import ReferenceDataParallel
from gcbench.trace import profiled

# the ranks' time limit: a first run in a checkout builds the kernels
RANKS_TIMEOUT_S = 1100.0
REPLICA_CHUNK = 1 << 22


def rank_rng(seed: int, i: int, rank: int, device) -> torch.Generator:
    """Rank ``rank``'s draws of step ``i``."""
    return torch.Generator(device=device).manual_seed(
        inputs.sub_seed(seed, 20, i, rank))


def rank_sample(samples: list, world: int, rank: int, i: int):
    return samples[(world * i + rank) % len(samples)]


def _state(modules: Dict[str, torch.nn.Module]) -> List[torch.Tensor]:
    """What the replicas hold alike: every parameter and floating
    buffer."""
    return [t for m in modules.values()
            for t in list(m.parameters()) + list(m.buffers())
            if t.is_floating_point()]


def replica_gap(modules: Dict[str, torch.nn.Module]) -> float:
    """The largest gap between this rank's weights and running state and
    rank 0's, over every rank (collectives: every rank calls it).  Rank
    0's values come in chunks of ``REPLICA_CHUNK`` elements, so that the
    check adds little to the card's peak."""
    import torch.distributed as dist

    gap = None
    for t in _state(modules):
        for mine in t.detach().reshape(-1).split(REPLICA_CHUNK):
            ref = mine.clone()
            dist.broadcast(ref, 0)
            g = (mine - ref).abs().max()
            gap = g if gap is None else torch.maximum(gap, g)
    # a NaN on either side is a gap: infinite, which every reduction keeps
    gap = torch.nan_to_num(gap.float(), nan=float("inf")).reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def _rank(rank: int, world: int, device, cell, seed: int, seconds: float,
          trace: bool, t_start: float) -> dict:
    import torch.distributed as dist

    from gaussiancity_tpu_torch.config import Config
    from gaussiancity_tpu_torch.training.step import (
        Trainer, make_parallel_train_step)

    torch.set_num_threads(HOST_THREADS)
    precision.float32()
    faults.plant_named(faults.Patcher().setattr)
    traffic = cell.traffic
    cfg = Config.from_dict(cell.config["config"])
    rcfg = weights.reference_config(cell.config)
    beta1 = float(rcfg.train.betas[0])
    samples = inputs.samples(cell, rcfg, seed, device)
    n_follow = int(traffic["followed_steps"])
    trainer = Trainer(cfg, device=device)
    if rank == 0:
        made = weights.train_models(rcfg, seed, device)
        weights.load_into(trainer.generator, made["generator"])
        weights.load_into(trainer.discriminator, made["discriminator"])
        weights.load_into(trainer.ploss.model, made["ploss"].model)
        del made
        gc.collect()
    step = make_parallel_train_step(trainer)
    devices.reset_peak(device)
    modules = {"G": trainer.generator, "D": trainer.discriminator}
    opts = {"G": trainer.g_opt, "D": trainer.d_opt}

    def rng(i):
        return rank_rng(seed, i, rank, device)

    ends = []

    def followed(batch, g):
        m = step(batch, g)
        devices.sync(device)
        ends.append(time.perf_counter())
        return m

    prog = _follow(followed, modules, opts,
                   [rank_sample(samples, world, rank, i)
                    for i in range(n_follow)], rng, n_follow,
                   _Capture(trainer), beta1)
    replicas = replica_gap(modules)
    unit = min((b - a for a, b in zip(ends, ends[1:])), default=1.0)
    n = torch.tensor([max(1, math.ceil(seconds / unit))], device=device)
    dist.broadcast(n, 0)
    n = int(n)
    devices.sync(device)
    dist.barrier()
    setup_s = time.perf_counter() - t_start

    bad = torch.zeros((), dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    for k in range(n):
        i = n_follow + k
        m = step(rank_sample(samples, world, rank, i), rng(i))
        # the counters are averaged over the ranks: above 0 where any
        # rank's is
        bad += (sum(m[c] for c in compare.COUNTER_KEYS) > 0).long()
    devices.sync(device)
    dist.barrier()
    window = time.perf_counter() - t0

    out = {"forbidden": [], "peak": 0, "device": str(device),
           "backend": dist.get_backend()}
    if trace:
        out.update(_traced(cell, trainer, step, samples, world, rank, rng,
                           n_follow + n, device))
    out["peak"] = devices.peak_bytes(device)
    if rank == 0:
        out.update(
            prog=prog, replicas=replicas, n=n, window=window,
            setup_s=setup_s, failed=int(bad),
            # the bytes of the step's all-reduces: both models' gradients,
            # their floating buffers and the metrics, in float32
            allreduce_bytes=4 * (sum(t.numel() for t in _state(modules))
                                 + len(m)))
    del trainer, step, modules, opts, samples
    gc.collect()
    out["forbidden"] = forbidden_modules()
    return out


def _traced(cell, trainer, step, samples, world, rank, rng, i0, device
            ) -> dict:
    """The instrumented pass (the trainer's stage timers), then the
    profiled pass, each of ``traced_steps`` steps on every rank."""
    n = int(cell.traffic["traced_steps"])

    def one(k):
        i = i0 + k
        step(rank_sample(samples, world, rank, i), rng(i))

    trainer.stage_ms.clear()
    trainer.time_stages = True
    for k in range(n):
        one(k)
    devices.sync(device)
    trainer.time_stages = False
    stage_ms = {k: list(v) for k, v in trainer.stage_ms.items()}
    return {"stage_ms": stage_ms,
            "profile": profiled(lambda k: one(n + k), n, device)}


def reference(cell, seed: int, device, counting: bool = False):
    """The reference's followed steps of the cell on ``device``, and with
    ``counting`` their work (``follow_reference``) a step and card."""
    traffic = cell.traffic
    world = int(traffic["world"])
    rcfg = weights.reference_config(cell.config)
    samples = inputs.samples(cell, rcfg, seed, device)
    n_follow = int(traffic["followed_steps"])
    rt = ReferenceDataParallel(rcfg, weights.train_models(rcfg, seed,
                                                          device))
    batches = [[rank_sample(samples, world, r, i) for r in range(world)]
               for i in range(n_follow)]
    ref, work = follow_reference(
        rt, batches, lambda i: [rank_rng(seed, i, r, device)
                                for r in range(world)],
        n_follow, float(rcfg.train.betas[0]), counting)
    if counting:
        work["flops_per_unit"] /= world
    return ref, work


def run(cell, seed: int, seconds: float, readers: dict, device: str,
        t_start: float):
    from gaussiancity_tpu_torch.parallel.launch import spawn_ranks

    world = int(cell.traffic["world"])
    store = tempfile.mkdtemp(prefix="gcbench_ranks_")
    try:
        outs = spawn_ranks(_rank, world, os.path.join(store, "store"),
                           args=(cell, seed, seconds, bool(readers),
                                 t_start), device=device,
                           timeout_s=RANKS_TIMEOUT_S)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    bad = sorted({m for o in outs for m in o["forbidden"]})
    if bad:
        log(f"a rank loaded forbidden modules: {bad}")
        raise SystemExit(3)
    used = sorted({o["device"] for o in outs})
    backends = sorted({o["backend"] for o in outs})
    log(f"ranks on {used} over {backends}")
    if torch.device(device).type == "cuda" and (
            len(used) != world or backends != ["nccl"]):
        log(f"{world} ranks need {world} cards over NCCL; had {len(used)} "
            f"over {backends}")
        raise SystemExit(3)
    r0 = outs[0]
    n, step_s = r0["n"], r0["window"] / r0["n"]
    log(f"set-up {r0['setup_s']:.3f} s; followed "
        f"{len(r0['prog']['losses'])} steps: {r0['prog']['losses']}")
    log(f"window: {n} steps of {world} ranks in {r0['window']:.3f} s, "
        f"{step_s * 1e3:.3f} ms a step; replicas {r0['replicas']!r}; "
        f"peak bytes by rank {[o['peak'] for o in outs]}")
    memory_peak = max(o["peak"] for o in outs)
    precision.float32()
    ref, work = reference(cell, seed, device, counting=bool(readers))
    numbers = compare.train_numbers(r0["prog"], ref)
    numbers["replicas"] = r0["replicas"]
    change_d = compare.worst_leaf(r0["prog"]["change"]["D"],
                                  ref["change"]["D"])
    log(f"not compared: change.D {change_d!r}")
    correct, compared = compare.judge(numbers, cell.limits)
    result = {"correct": correct, "attempted": n, "failed": r0["failed"],
              "metrics": {"train_step_ms": {"value": step_s * 1e3,
                                            "unit": "ms"},
                          "setup_s": {"value": r0["setup_s"], "unit": "s"}},
              "device": {"platform": "gpu", "kind": devices.name(device),
                         "count": len(used),
                         "memory_peak_bytes": int(memory_peak)}}
    if readers:
        ctx = Context(kind="train", unit_s=step_s,
                      n_traced=int(cell.traffic["traced_steps"]),
                      profile=r0["profile"],
                      ranks=[o["profile"] for o in outs],
                      stage_ms=r0["stage_ms"],
                      work=dict(work, allreduce_bytes=r0["allreduce_bytes"],
                                world=world))
        read_per_layer(cell, ctx, readers, result)
        # the device's busy time, averaged over the ranks' cards
        result["device"]["busy_s"] = statistics.mean(
            o["profile"].busy_s() for o in outs)
    return result, compared
