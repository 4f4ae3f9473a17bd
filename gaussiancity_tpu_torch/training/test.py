# -*- coding: utf-8 -*-
"""Validation loop (counterpart of ``gaussiancity_tpu/training/test.py``;
upstream core/test.py:22-125): ``Trainer.eval_step`` on each batch of the
centre-cropped val split, the mean masked L1, and side-by-side key frames
(fake | real) to the writer."""

from __future__ import annotations

import logging
import numpy as np
import torch

from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.utils import helpers
from gaussiancity_tpu_torch.utils.average_meter import AverageMeter


def to_device(batch, device) -> dict:
    """A numpy batch of the loader as tensors on ``device`` (float32,
    except the bool point mask and the int32 crop origin)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def test(cfg: Config, trainer, loader, writer=None, epoch: int = 0
         ) -> float:
    """The mean L1 of the val split, with one key frame per batch.  Every
    batch draws its z table from a generator seeded 0, as the JAX loop
    passes one fixed key."""
    meter = AverageMeter(["L1Loss"])
    for i, batch in enumerate(loader.epoch(0)):
        batch = to_device(batch, trainer.device)
        rng = torch.Generator(device=trainer.device).manual_seed(0)
        metrics, fake = trainer.eval_step(batch, rng)
        meter.update([float(metrics["L1Loss"])])
        if writer is not None:
            side = np.concatenate(
                [helpers.tensor_to_image(fake[0], "RGB"),
                 helpers.tensor_to_image(batch["rgb"][0], "RGB")], axis=1)
            writer.add_images({f"Images/Val/{i:04d}": side}, epoch)
    avg = meter.avg(0)
    logging.info("[Val][Epoch %d] L1Loss %.4f", epoch, avg)
    if writer is not None:
        writer.add_scalars({"Loss/Epoch/L1Loss/Val": avg}, epoch)
    return avg
