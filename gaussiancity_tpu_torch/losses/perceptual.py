# -*- coding: utf-8 -*-
"""VGG perceptual loss (counterpart of
``gaussiancity_tpu/losses/perceptual.py``; upstream
losses/perceptual.py:16-235).

A VGG19 (or VGG16) trunk of 3x3 SAME convs, ReLU and 2x2 max pools that
stops at the last wanted layer, ImageNet renormalization of [-1, 1]
inputs, and the weighted L1 (``criterion="l1"``) or squared
(``"l2"``) distance of the named relu activations, at ``num_scales``
scales (each the last one's 2x2 average pool).  With a compute ``dtype``
(bfloat16) the convolutions compute in it, as ``nn.Conv(dtype=...)`` does
in the JAX package, and the feature differences are taken in float32.  The
weights come from the same ``.npz`` file as the JAX package's
(``GAUSSIANCITY_VGG19_NPZ``, keys ``conv_{s}_{c}/kernel`` in HWIO and
``conv_{s}_{c}/bias``); without it the trunk keeps its seeded random
weights, behind the same opt-in gate (``check_vgg_weights``).  Images are
NHWC at the public functions, as in the JAX package.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussiancity_tpu_torch.models.layers import conv2d
from gaussiancity_tpu_torch.utils import profiling

_VGG19_STAGES = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
_VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

VGG_NPZ_ENV = "GAUSSIANCITY_VGG19_NPZ"
ALLOW_RANDOM_VGG_ENV = "GAUSSIANCITY_ALLOW_RANDOM_VGG"


class VGGFeatures(nn.Module):
    """VGG trunk returning the wanted relu activations by name
    (``relu_{stage}_{conv}``), NCHW."""

    def __init__(self, stages: Tuple[Tuple[int, int], ...] = _VGG19_STAGES,
                 wanted: Sequence[str] = ("relu_3_1", "relu_4_1",
                                          "relu_5_1"),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.wanted = tuple(wanted)
        self.plan = []  # (name, pool after) in evaluation order
        in_ch = 3
        found = 0
        for si, (ch, n_convs) in enumerate(stages, start=1):
            for ci in range(1, n_convs + 1):
                name = f"conv_{si}_{ci}"
                self.add_module(name, nn.Conv2d(in_ch, ch, 3, 1, 1))
                in_ch = ch
                found += f"relu_{si}_{ci}" in self.wanted
                self.plan.append((name, ci == n_convs))
                if found == len(self.wanted):
                    return

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                with torch.no_grad():
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        with profiling.span("vgg"):
            out = {}
            for name, pool in self.plan:
                conv = getattr(self, name)
                x = F.relu(conv2d(x, conv.weight, conv.bias,
                                  self.compute_dtype, 1, 1))
                relu = "relu" + name[4:]
                if relu in self.wanted:
                    out[relu] = x
                if pool and len(out) < len(self.wanted):
                    x = F.max_pool2d(x, 2, 2)
            return out


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NHWC -> ImageNet-normalized NHWC."""
    mean = x.new_tensor(_IMAGENET_MEAN)
    std = x.new_tensor(_IMAGENET_STD)
    return ((x + 1.0) / 2.0 - mean) / std


class PerceptualLoss(nn.Module):
    """forward(inp, target) with NHWC images in [-1, 1] -> scalar; the
    target's features carry no gradient."""

    def __init__(self, network: str = "vgg19",
                 layers: Sequence[str] = ("relu_3_1", "relu_4_1",
                                          "relu_5_1"),
                 weights: Optional[Sequence[float]] = None,
                 criterion: str = "l1", num_scales: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if criterion not in ("l1", "l2"):
            raise ValueError(f"unknown criterion {criterion!r}")
        self.criterion = criterion
        self.num_scales = num_scales
        self.layers = tuple(layers)
        self.weights = (tuple(weights) if weights is not None
                        else (1.0,) * len(self.layers))
        if len(self.layers) != len(self.weights):
            raise ValueError("one weight per layer")
        stages = _VGG19_STAGES if network == "vgg19" else _VGG16_STAGES
        self.model = VGGFeatures(stages, self.layers, dtype)
        self.model.requires_grad_(False)

    def forward(self, inp: torch.Tensor, target: torch.Tensor
                ) -> torch.Tensor:
        loss = inp.new_zeros(())
        for scale in range(self.num_scales):
            fi = self.model(normalize_imagenet(inp).permute(0, 3, 1, 2))
            with torch.no_grad():
                ft = self.model(normalize_imagenet(target).permute(0, 3, 1,
                                                                   2))
            for layer, w in zip(self.layers, self.weights):
                diff = fi[layer].float() - ft[layer].float()
                loss = loss + w * (diff.abs().mean() if self.criterion == "l1"
                                   else (diff ** 2).mean())
            if scale != self.num_scales - 1:
                inp, target = _downsample2x(inp), _downsample2x(target)
        return loss


def _downsample2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2 average pool: torch's ``F.interpolate(scale_factor=0.5,
    bilinear, align_corners=False)``, which upstream takes, samples each
    output exactly between four inputs."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def load_vgg19_npz(path: str, model: VGGFeatures) -> None:
    """Copy ``conv_{s}_{c}/kernel`` (HWIO) and ``/bias`` arrays from an npz
    into ``model`` where the names and shapes match."""
    data = np.load(path)
    state = model.state_dict()
    for key, value in state.items():
        name, kind = key.rsplit(".", 1)
        npz_key = f"{name}/{'kernel' if kind == 'weight' else 'bias'}"
        if npz_key not in data.files:
            continue
        arr = np.asarray(data[npz_key], np.float32)
        if kind == "weight":
            arr = arr.transpose(3, 2, 0, 1)
        if tuple(arr.shape) == tuple(value.shape):
            state[key] = torch.from_numpy(arr)
    model.load_state_dict(state)


def check_vgg_weights(perceptual_loss_factor: float,
                      allow_random_vgg: bool) -> Optional[str]:
    """The JAX package's gate (``training/step.py:85-114``): returns the
    npz path when ``GAUSSIANCITY_VGG19_NPZ`` names a file; otherwise
    warns when random VGG weights are allowed (``allow_random_vgg`` or
    ``GAUSSIANCITY_ALLOW_RANDOM_VGG=1``) and raises when they are not."""
    if perceptual_loss_factor == 0.0:
        return None
    path = os.environ.get(VGG_NPZ_ENV)
    if path and os.path.exists(path):
        return path
    msg = (f"{VGG_NPZ_ENV} is unset or missing ({path!r}): the perceptual "
           "loss will use RANDOM VGG features, and training quality cannot "
           "match the reference.  Convert the ImageNet VGG19 weights to an "
           "npz with keys conv_{s}_{c}/kernel (HWIO) and conv_{s}_{c}/bias "
           f"and point {VGG_NPZ_ENV} at it.")
    if allow_random_vgg or os.environ.get(ALLOW_RANDOM_VGG_ENV) == "1":
        logging.warning("=" * 72 + "\n" + msg + "\n" + "=" * 72)
        return None
    raise ValueError(msg + f"  (Set train.allow_random_vgg=True or "
                     f"{ALLOW_RANDOM_VGG_ENV}=1 to proceed anyway.)")
