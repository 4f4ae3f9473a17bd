# -*- coding: utf-8 -*-
"""N+1-label semantic GAN loss (counterpart of
``gaussiancity_tpu/losses/gan.py``; upstream losses/gan.py:15-97).

``pred`` has ``n_classes + 1`` channels, the last being the "fake" class;
``label`` is the n_classes one-hot seg map.  Channel 0 (the NULL class) is
zeroed in both before the log-softmax.  Layout NHWC, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import torch


def gan_loss(pred: torch.Tensor, label: torch.Tensor, t_real: bool,
             weight: Optional[torch.Tensor] = None,
             dis_update: bool = True) -> torch.Tensor:
    """pred [B, H, W, n_classes + 1], label [B, H, W, n_classes], weight
    broadcastable to [B, H, W, 1]."""
    if pred.shape[-1] != label.shape[-1] + 1:
        raise ValueError("pred needs one channel more than label")
    if not (dis_update or t_real):
        raise ValueError("the generator's GAN loss must aim for real")
    label = torch.cat([torch.zeros_like(label[..., :1]), label[..., 1:]], -1)
    pred = torch.cat([torch.zeros_like(pred[..., :1]), pred[..., 1:]], -1)
    logp = torch.log_softmax(pred, dim=-1)
    if t_real:
        loss = -(label * logp[..., :-1]).sum(dim=-1, keepdim=True)
    else:
        loss = -logp[..., -1:]
    if weight is not None:
        loss = loss * weight
    return loss.mean()
