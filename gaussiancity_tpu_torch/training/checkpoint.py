# -*- coding: utf-8 -*-
"""Train-state checkpoints of the port (counterpart of
``gaussiancity_tpu/training/checkpoint.py``): one ``torch.save`` file with
the G and D weights, the spectral-norm buffers, both Adam states, the step,
the VGG weights and the config as JSON.  Reading the JAX package's Orbax
checkpoints is a later slice's work."""

from __future__ import annotations

import os

import torch

from gaussiancity_tpu_torch.config import Config


def save_checkpoint(path: str, trainer) -> None:
    """Write ``trainer.state_dict()`` and its config to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"config": trainer.cfg.to_json(),
                "state": trainer.state_dict()}, path)


def load_checkpoint(path: str, trainer) -> Config:
    """Restore ``trainer`` from ``path`` (onto the trainer's device) and
    return the config saved with it."""
    blob = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.load_state_dict(blob["state"])
    return Config.from_json(blob["config"])
