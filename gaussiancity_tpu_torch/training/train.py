# -*- coding: utf-8 -*-
"""The training loop (counterpart of ``gaussiancity_tpu/training/train.py``;
upstream core/train.py:30-397): loaders, the ``Trainer``, logging, per-epoch
validation, checkpoints and resume, on one device.

Metrics stay on the device between logs: each step stacks its metrics
into one small tensor, and every ``log_freq`` steps one copy brings the
window to the host, where the loss meters, the writer and the overflow
warnings read it.

Data-parallel: when the default process group holds several ranks
(``parallel.mesh.init_dist``), ``train`` runs as one process a rank, on
the rank's device, with ``make_parallel_train_step``.  Each rank loads
its own share of every epoch, the master alone writes the logs and the
checkpoints, and the other ranks wait at a barrier before a resume reads
them."""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.data.datasets import DataLoader, get_dataset
from gaussiancity_tpu_torch.training import checkpoint as ckpt
from gaussiancity_tpu_torch.parallel import mesh
from gaussiancity_tpu_torch.training.step import (Trainer,
                                                  make_parallel_train_step)
from gaussiancity_tpu_torch.training.test import test as run_test
from gaussiancity_tpu_torch.training.test import to_device
from gaussiancity_tpu_torch.utils.average_meter import AverageMeter
from gaussiancity_tpu_torch.utils.summary_writer import SummaryWriter

LOSS_NAMES = ["L1Loss", "PerceptualLoss", "GANLoss", "GANLossFake",
              "GANLossReal", "GenLoss", "DisLoss"]
COUNTER_NAMES = ["RasterDroppedPairs", "RasterTruncated",
                 "RasterGradTruncated", "PTv3PoolOverflow"]


def _warn_overflow(m: dict, epoch_idx: int, gstep: int) -> None:
    n_drop, n_trunc = m["RasterDroppedPairs"], m["RasterTruncated"]
    if n_drop + n_trunc > 0:
        logging.warning(
            "[Epoch %d][step %d] rasterizer binning overflow: %d dropped "
            "pairs, %d truncated tiles: raise rasterizer.tile_capacity",
            epoch_idx, gstep, int(n_drop), int(n_trunc))
    if m["RasterGradTruncated"] > 0:
        logging.warning(
            "[Epoch %d][step %d] rasterizer backward truncated %d gradient "
            "slots: raise rasterizer.grad_budget", epoch_idx, gstep,
            int(m["RasterGradTruncated"]))
    if m["PTv3PoolOverflow"] > 0:
        logging.warning(
            "[Epoch %d][step %d] PTv3 neighbour overflow: %d points outside "
            "the dense neighbour extent: raise network.ptv3."
            "dense_nbr_extent", epoch_idx, gstep,
            int(m["PTv3PoolOverflow"]))


def train(cfg: Config, dataset_name: Optional[str] = None,
          resume_from: Optional[str] = None,
          max_steps: Optional[int] = None, device=None) -> Trainer:
    """Train ``cfg`` on ``dataset_name`` (default ``cfg.dataset.name``)
    for ``cfg.train.n_epochs`` epochs, or until ``max_steps`` steps in all,
    on ``device`` (the card unless the caller asks for the CPU).  Resumes
    from the latest epoch checkpoint in the directory ``resume_from``: the
    port's own files, or the JAX package's Orbax checkpoints (Adam's
    moments and the step included), after which the run goes on from the
    saved epoch + 1 and writes the port's files.  ``cfg.train.seed`` seeds
    the weights, the loader and the steps' draws.  Returns the trainer."""
    seed = cfg.train.seed
    dataset_name = dataset_name or cfg.dataset.name
    world = mesh.get_world_size()
    # the loader shards by rank: rank r's i-th batch (batch size 1) is
    # item r + i * world of the epoch's order, the sample that the JAX
    # loop's device r takes at step i from its global batch
    train_loader = DataLoader(
        get_dataset(cfg, dataset_name, "train"),
        batch_size=cfg.train.batch_size, shuffle=True, seed=seed,
        num_workers=cfg.train.n_workers,
        prefetch=cfg.train.prefetch_batches)
    val_loader = DataLoader(
        get_dataset(cfg, dataset_name, "val"),
        batch_size=cfg.train.batch_size, shuffle=False,
        num_workers=cfg.train.n_workers,
        prefetch=cfg.train.prefetch_batches)
    ckpt_dir = f"{cfg.output_dir}/ckpt/{cfg.exp_name or 'default'}"
    if ckpt.is_orbax(ckpt_dir):
        raise ValueError(
            f"{ckpt_dir} holds the JAX package's Orbax checkpoints; the "
            "port writes its own epoch files, so give this run another "
            "experiment name (-e) and resume from that directory with -p")
    trainer = Trainer(cfg, device=device, seed=seed)

    init_epoch = 0
    if resume_from:
        if world > 1:
            torch.distributed.barrier()
        _, init_epoch = ckpt.restore_checkpoint(resume_from, trainer)
        logging.info("Resumed from %s at epoch %d", resume_from, init_epoch)
    train_step = (make_parallel_train_step(trainer) if world > 1
                  else trainer.train_step)

    master = mesh.is_master()
    writer = None
    if master:
        writer = SummaryWriter(cfg.output_dir, cfg.exp_name)
        writer.add_config(cfg.to_dict())
    n_batches = len(train_loader)
    global_step = trainer.step
    log_freq = max(1, cfg.train.log_freq)
    metric_keys = LOSS_NAMES + COUNTER_NAMES
    done = False

    for epoch_idx in range(init_epoch + 1, cfg.train.n_epochs + 1):
        epoch_t0 = time.time()
        batch_time, data_time = AverageMeter(), AverageMeter()
        meters = AverageMeter(LOSS_NAMES)
        pending: List[Tuple[int, torch.Tensor]] = []

        def flush(batch_idx: int) -> None:
            """One copy to the host for the window of steps."""
            if not pending:
                return
            vals = torch.stack([v for _, v in pending]).cpu().numpy()
            for (gstep, _), row in zip(pending, vals):
                m = dict(zip(metric_keys, row.tolist()))
                meters.update([m[k] for k in LOSS_NAMES])
                _warn_overflow(m, epoch_idx, gstep)
                if writer is not None:
                    writer.add_scalars({f"Loss/Batch/{k}": m[k]
                                        for k in LOSS_NAMES}, gstep)
                    writer.add_scalars({f"Raster/Batch/{k}": m[k]
                                        for k in COUNTER_NAMES}, gstep)
            logging.info(
                "[Epoch %d/%d][Batch %d/%d] BatchTime %.3fs DataTime %.3fs "
                "Losses %s", epoch_idx, cfg.train.n_epochs, batch_idx + 1,
                n_batches, batch_time.val(), data_time.val(),
                ["%.4f" % v for v in vals[-1][:len(LOSS_NAMES)]])
            pending.clear()

        t_end = time.time()
        batch_idx = -1
        for batch_idx, batch in enumerate(train_loader.epoch(epoch_idx)):
            data_time.update(time.time() - t_end)
            metrics = train_step(to_device(batch, trainer.device))
            global_step += 1
            pending.append((global_step, torch.stack(
                [metrics[k].float() for k in metric_keys])))
            batch_time.update(time.time() - t_end)
            t_end = time.time()
            if len(pending) >= log_freq:
                flush(batch_idx)
            if max_steps is not None and global_step >= max_steps:
                done = True
                break
        flush(batch_idx)

        if writer is not None:
            writer.add_scalars({f"Loss/Epoch/{k}/Train": v
                                for k, v in meters.as_dict().items()},
                               epoch_idx)
        logging.info("[Epoch %d/%d] done in %.2fs; avg %s", epoch_idx,
                     cfg.train.n_epochs, time.time() - epoch_t0,
                     ["%.4f" % v for v in meters.avg()])
        if epoch_idx % cfg.test.test_freq == 0:
            run_test(cfg, trainer, val_loader, writer=writer,
                     epoch=epoch_idx)
        if master and (done or epoch_idx % cfg.train.ckpt_save_freq == 0
                       or epoch_idx == cfg.train.n_epochs):
            ckpt.save_epoch(ckpt_dir, epoch_idx, trainer)
        if done:
            break

    if writer is not None:
        writer.close()
    return trainer
