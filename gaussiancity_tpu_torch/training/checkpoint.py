# -*- coding: utf-8 -*-
"""Train-state checkpoints of the port (counterpart of
``gaussiancity_tpu/training/checkpoint.py``; upstream core/train.py:
374-394).  A checkpoint is one ``torch.save`` file of the G and D weights,
the spectral-norm and BatchNorm buffers, both Adam states, the step, the
VGG weights and the config as JSON.

``save_checkpoint`` / ``load_checkpoint`` write and read one such file.
The training loop keeps one per epoch under ``output_dir/ckpt/<exp_name>/``
(``save_epoch``, ``latest_epoch``, ``restore_checkpoint``), each written to
a temporary name and renamed into place, so a cut run leaves no half file.
Reading the JAX package's Orbax checkpoints is a later slice's work."""

from __future__ import annotations

import hashlib
import os
import re
from typing import Optional, Tuple

import torch

from gaussiancity_tpu_torch.config import Config

_EPOCH_FILE = re.compile(r"^epoch-(\d+)\.pt$")


def save_checkpoint(path: str, trainer) -> None:
    """Write ``trainer.state_dict()`` and its config to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"config": trainer.cfg.to_json(),
                "state": trainer.state_dict()}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, trainer) -> Config:
    """Restore ``trainer`` from ``path`` (onto the trainer's device) and
    return the config saved with it."""
    blob = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.load_state_dict(blob["state"])
    return Config.from_json(blob["config"])


def epoch_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch-{epoch:05d}.pt")


def save_epoch(ckpt_dir: str, epoch: int, trainer) -> str:
    """The checkpoint of the end of ``epoch``; returns its path."""
    path = epoch_path(ckpt_dir, epoch)
    save_checkpoint(path, trainer)
    return path


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """The last epoch with a checkpoint in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [int(m.group(1)) for m in map(_EPOCH_FILE.match,
                                             os.listdir(ckpt_dir)) if m]
    return max(epochs) if epochs else None


def restore_checkpoint(ckpt_dir: str, trainer,
                       epoch: Optional[int] = None) -> Tuple[Config, int]:
    """Restore ``trainer`` from the checkpoint of ``epoch`` (the latest
    where None) in ``ckpt_dir``; returns (the saved config, the epoch)."""
    epoch = epoch if epoch is not None else latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return load_checkpoint(epoch_path(ckpt_dir, epoch), trainer), epoch


def state_digest(trainer) -> str:
    """SHA-256 of every parameter and buffer of the trainer's generator and
    discriminator and of both Adam states, in a fixed order: ranks of a
    data-parallel run whose digests are equal hold bit-equal replicas."""
    h = hashlib.sha256()
    for m in (trainer.generator, trainer.discriminator):
        if m is None:
            continue
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            h.update(name.encode())
            h.update(_bytes(t))
    for opt in (trainer.g_opt, trainer.d_opt):
        if opt is None:
            continue
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                for k in sorted(st):
                    if torch.is_tensor(st[k]):
                        h.update(_bytes(st[k]))
    return h.hexdigest()


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
