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

``latest_epoch``, ``restore_checkpoint`` and ``load_checkpoint`` also take
a directory of the JAX package's Orbax checkpoints (one subdirectory per
step, ``orbax_reader``): the whole ``TrainState`` is read, Adam's moments
included, and carried in by ``interop.load_train_state``.  A directory
that holds both kinds raises rather than pick one.  Saving is always the
port's own file."""

from __future__ import annotations

import hashlib
import os
import re
from typing import Optional, Tuple

import torch

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.ops.hash_grid import raise_if_legacy_table
from gaussiancity_tpu_torch.training import orbax_reader

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
    return the config saved with it.  ``path`` is one of the port's files,
    or an Orbax checkpoint directory (its latest step is read)."""
    if os.path.isdir(path):
        return restore_orbax(path, trainer)[0]
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


def is_orbax(ckpt_dir: str) -> bool:
    """Whether ``ckpt_dir`` is a directory of Orbax checkpoints; raises
    where it also holds the port's epoch files."""
    if not orbax_reader.is_orbax_directory(ckpt_dir):
        return False
    if any(map(_EPOCH_FILE.match, os.listdir(ckpt_dir))):
        raise ValueError(
            f"{ckpt_dir} holds both Orbax checkpoint steps and the port's "
            "epoch-*.pt files; move one kind elsewhere")
    return True


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """The last epoch with a checkpoint in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    if is_orbax(ckpt_dir):
        return orbax_reader.latest_step(ckpt_dir)
    epochs = [int(m.group(1)) for m in map(_EPOCH_FILE.match,
                                             os.listdir(ckpt_dir)) if m]
    return max(epochs) if epochs else None


def restore_checkpoint(ckpt_dir: str, trainer,
                       epoch: Optional[int] = None) -> Tuple[Config, int]:
    """Restore ``trainer`` from the checkpoint of ``epoch`` (the latest
    where None) in ``ckpt_dir``; returns (the saved config, the epoch)."""
    if is_orbax(ckpt_dir):
        return restore_orbax(ckpt_dir, trainer, epoch)
    epoch = epoch if epoch is not None else latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return load_checkpoint(epoch_path(ckpt_dir, epoch), trainer), epoch


def check_orbax_tables(ck: "orbax_reader.OrbaxCheckpoint", generator,
                       select=None) -> None:
    """Refuse a legacy packed hash table before any weight is read (a
    generator without a hash grid has nothing to check)."""
    table = getattr(getattr(generator, "pos_encoder", None), "embeddings",
                    None)
    if table is not None:
        raise_if_legacy_table(ck.shapes(select), tuple(table.shape),
                              f"{ck.directory} step {ck.step}")


def restore_orbax(ckpt_dir: str, trainer, epoch: Optional[int] = None
                  ) -> Tuple[Config, int]:
    """Restore ``trainer`` from the JAX package's Orbax checkpoint of
    ``epoch`` (its latest step where None): weights, batch and spectral-
    norm statistics, VGG, both Adam states and the step.  Returns (the
    saved config, the saved epoch)."""
    ck = orbax_reader.OrbaxCheckpoint(ckpt_dir, epoch)
    check_orbax_tables(ck, trainer.generator)
    interop.load_train_state(trainer, ck.tree())
    return ck.config, ck.epoch


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
