"""Training losses of the reference."""

import torch

from gcbench.reference.gct.losses.gan import gan_loss  # noqa: F401
from gcbench.reference.gct.losses.perceptual import (  # noqa: F401
    PerceptualLoss)


def masked_l1(a: torch.Tensor, b: torch.Tensor,
              mask: torch.Tensor = None) -> torch.Tensor:
    """Mean absolute difference of the mask-multiplied images."""
    if mask is not None:
        a = a * mask
        b = b * mask
    return (a - b).abs().mean()
