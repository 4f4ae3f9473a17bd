# -*- coding: utf-8 -*-
"""Checkpoints -> inference-ready generators, and the city a video is
rendered from (counterpart of ``gaussiancity_tpu/inference/loader.py``;
upstream scripts/inference.py:57-133).

``load_generator`` reads one of the port's own per-epoch checkpoints
(``training/checkpoint.py``) or a step of the JAX package's Orbax
checkpoints (``training/orbax_reader.py``) and rebuilds the ``Generator``
from the config saved in it; ``get_models`` does so for the REST / BLDG /
CAR generators of a video.  ``get_city_projections`` and
``get_random_city`` load a city's projection maps and instance centres."""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.data import dataset_generator as dg
from gaussiancity_tpu_torch.device import resolve_device
from gaussiancity_tpu_torch.models.generator import Generator
from gaussiancity_tpu_torch.training import checkpoint as ckpt
from gaussiancity_tpu_torch.training import orbax_reader

# the leaves of a train state that a frame needs
GENERATOR_ITEMS = ("g_params", "g_stats", "z_bank")


def load_generator(ckpt_dir: str, epoch: Optional[int] = None, device=None
                   ) -> Tuple[Config, Generator, Optional[dict]]:
    """The generator of the checkpoint of ``epoch`` (the latest where
    None) in ``ckpt_dir`` -> (the saved config, the generator in eval mode
    on ``device``, its style bank or None).

    The file also holds the discriminator, VGG19 and both Adam states: it
    is memory-mapped and only the generator's weights and buffers (PTv3's
    running statistics included) are moved to the device.  The device is
    the card unless the caller asks for the CPU.  From an Orbax directory
    only the generator's leaves (``GENERATOR_ITEMS``) are decoded."""
    device = resolve_device(device)
    if ckpt.is_orbax(ckpt_dir):
        return load_orbax_generator(ckpt_dir, epoch, device)
    epoch = epoch if epoch is not None else ckpt.latest_epoch(ckpt_dir)
    if epoch is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = ckpt.epoch_path(ckpt_dir, epoch)
    blob = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    cfg = Config.from_json(blob["config"])
    state = blob["state"]
    module = Generator(cfg.network, n_classes=cfg.dataset.n_classes,
                       proj_size=cfg.dataset.proj_size)
    module.load_state_dict(state["generator"])
    logging.info("restored %s (epoch %d): %d generator tensors", path, epoch,
                 len(state["generator"]))
    return cfg, module.to(device).eval(), state.get("z_bank")


def load_orbax_generator(ckpt_dir: str, epoch: Optional[int] = None,
                         device=None
                         ) -> Tuple[Config, Generator, Optional[dict]]:
    """``load_generator`` of a JAX Orbax checkpoint directory (counterpart
    of ``gaussiancity_tpu/inference/loader.py``): a PTv3 generator whose
    checkpoint has no ``g_stats`` raises, as there."""
    ck = orbax_reader.OrbaxCheckpoint(ckpt_dir, epoch)
    cfg = ck.config
    module = Generator(cfg.network, n_classes=cfg.dataset.n_classes,
                       proj_size=cfg.dataset.proj_size)
    select = orbax_reader.under(*GENERATOR_ITEMS)
    ckpt.check_orbax_tables(ck, module, select)
    has_stats = any(p[0] == "g_stats" and len(p) > 1 for p in ck.paths())
    if cfg.network.ptv3.enabled and not has_stats:
        # a PTv3 generator at eval normalizes with the running statistics
        raise ValueError(
            f"checkpoint {ckpt_dir} has a PTv3 generator but no BN running "
            "stats ('g_stats'): it predates the running-average BatchNorm; "
            "re-save it from a resumed training run")
    state = ck.tree(select)
    module.load_state_dict(interop.generator_state_from_flax(
        {"params": state["g_params"],
         "batch_stats": state.get("g_stats") or {}}, cfg.network))
    logging.info("restored %s (step %d, epoch %d): %d generator tensors, "
                 "%.1f MB read in %.3f s", ckpt_dir, ck.step, ck.epoch,
                 len(module.state_dict()), ck.compressed_bytes / 1e6,
                 ck.load_seconds)
    return cfg, module.to(device).eval(), state.get("z_bank")


def get_models(ckpt_dirs: Dict[str, str], device=None
               ) -> Tuple[Config, Dict[str, Generator],
                          Dict[str, Optional[dict]]]:
    """The per-class generators (upstream scripts/inference.py:57-108).

    ``ckpt_dirs`` maps a class name to its checkpoint directory, e.g.
    {"REST": dir, "BLDG": dir[, "CAR": dir]}.  Returns (the REST model's
    config, which sets the camera and dataset, else the first one's; the
    models; their style banks)."""
    if not ckpt_dirs:
        raise ValueError("at least one checkpoint directory is required")
    models: Dict[str, Generator] = {}
    z_banks: Dict[str, Optional[dict]] = {}
    base_cfg = None
    for name, d in ckpt_dirs.items():
        cfg, models[name], z_banks[name] = load_generator(d, device=device)
        if name == "REST" or base_cfg is None:
            base_cfg = cfg
    return base_cfg, models, z_banks


def get_city_projections(city_dir: str):
    """One city directory -> (projections, centres); the centres are
    computed from the maps where the city has no ``CENTERS.pkl``
    (upstream dataset_generator.py:909-933, inference.py:126-133)."""
    projections = dg.load_projections(os.path.join(city_dir, "Projection"))
    if not projections:
        raise FileNotFoundError(f"no Projection/*.png under {city_dir}")
    centers_path = os.path.join(city_dir, "CENTERS.pkl")
    if os.path.exists(centers_path):
        with open(centers_path, "rb") as fp:
            centers = pickle.load(fp)
    else:
        centers = dg.get_centers_from_projections("GOOGLE_EARTH",
                                                  projections)
    return projections, centers


def get_random_city(data_root: str,
                    rng: Optional[np.random.Generator] = None) -> str:
    """A random city directory (one with ``Projection/``) under a dataset
    root (upstream scripts/inference.py:111-124)."""
    rng = rng or np.random.default_rng()
    cities = sorted(
        d for d in os.listdir(data_root)
        if os.path.isdir(os.path.join(data_root, d, "Projection")))
    if not cities:
        raise FileNotFoundError(
            f"no city directory with Projection/ under {data_root}")
    return os.path.join(data_root, cities[int(rng.integers(len(cities)))])
