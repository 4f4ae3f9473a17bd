"""Weights from the seed, made on the device by the reference's own
initialisers (a ``torch.Generator`` on the run's device), and handed
alike to the program (``load_into``) and to the reference, which builds
them again from the same seed when it runs."""

from __future__ import annotations

from typing import Dict

import torch

from gcbench.inputs import sub_seed
from gcbench.reference.gct import config as ref_config
from gcbench.reference.gct.losses.perceptual import PerceptualLoss
from gcbench.reference.gct.models.discriminator import Discriminator
from gcbench.reference.gct.models.generator import Generator


def reference_config(conf: dict):
    """The configuration file's ``config`` as the reference's Config."""
    return ref_config.Config.from_dict(conf["config"])


def _draw(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def generator_model(cfg, seed: int, tag: int, device) -> Generator:
    """The reference generator of ``cfg`` with weights drawn from
    (seed, tag) on ``device``."""
    with torch.device(device):
        g = Generator(cfg.network, n_classes=cfg.dataset.n_classes,
                      proj_size=cfg.dataset.proj_size)
    g.reset_parameters(_draw(seed, tag, device))
    return g


def train_models(cfg, seed: int, device) -> Dict[str, torch.nn.Module]:
    """Generator, discriminator and VGG of a train cell, drawn in that
    order from one generator seeded from (seed, 10)."""
    gen = _draw(seed, 10, device)
    with torch.device(device):
        g = Generator(cfg.network, n_classes=cfg.dataset.n_classes,
                      proj_size=cfg.dataset.proj_size)
        d = Discriminator(n_channel_base=cfg.network.dis_n_channel_base,
                          n_classes=cfg.dataset.n_classes)
        tr = cfg.train
        p = PerceptualLoss(network=tr.perceptual_loss_model,
                           layers=tr.perceptual_loss_layers,
                           weights=tr.perceptual_loss_weights)
    g.reset_parameters(gen)
    d.reset_parameters(gen)
    p.model.reset_parameters(gen)
    return {"generator": g, "discriminator": d, "ploss": p}


@torch.no_grad()
def load_into(module: torch.nn.Module, source: torch.nn.Module) -> None:
    """Copy ``source``'s parameters and buffers into the program's
    ``module`` of the same layout (strict: every name must match)."""
    module.load_state_dict(source.state_dict(), strict=True)
