# -*- coding: utf-8 -*-
"""Training losses (counterpart of ``gaussiancity_tpu/losses``)."""

import torch

from gaussiancity_tpu_torch.losses.gan import gan_loss  # noqa: F401
from gaussiancity_tpu_torch.losses.perceptual import (  # noqa: F401
    PerceptualLoss)
from gaussiancity_tpu_torch.losses.smoothness import (  # noqa: F401
    smoothness_loss)


def masked_l1(a: torch.Tensor, b: torch.Tensor,
              mask: torch.Tensor = None) -> torch.Tensor:
    """Mean absolute difference of the mask-multiplied images."""
    if mask is not None:
        a = a * mask
        b = b * mask
    return (a - b).abs().mean()
