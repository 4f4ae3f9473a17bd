# -*- coding: utf-8 -*-
"""Second-derivative filter-bank smoothness loss (counterpart of
``gaussiancity_tpu/losses/smoothness.py``; upstream
losses/smoothness.py:15-80, defined there and used by no training loop).

NHWC inputs of one channel.  Four 3x3 second-difference filters (x, y and
the two diagonals, or x and y only), applied with SAME padding; the
smooth-L1 (Huber, beta 1) of the filtered differences, masked away from
the borders each filter reaches past, averaged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_FILTER_X = np.array([[0, 0, 0.0], [1, -2, 1], [0, 0, 0]], np.float32)
_FILTER_Y = np.array([[0, 1, 0.0], [0, -2, 0], [0, 1, 0]], np.float32)
_FILTER_D1 = np.array([[1, 0, 0.0], [0, -2, 0], [0, 0, 1]], np.float32)
_FILTER_D2 = np.array([[0, 0, 1.0], [0, -2, 0], [1, 0, 0]], np.float32)


def _filters(use_diag: bool) -> np.ndarray:
    """[n_filters, 1, 3, 3] (OIHW)."""
    fs = [_FILTER_X, _FILTER_Y] + ([_FILTER_D1, _FILTER_D2] if use_diag
                                   else [])
    return np.stack(fs)[:, None]


def _masks(H: int, W: int, use_diag: bool) -> np.ndarray:
    """[n_filters, H, W]: 0 on the rows / columns a filter's SAME padding
    reaches into, as the JAX package masks them."""
    def mask(pad_ud, pad_lr):
        m = np.zeros((H, W), np.float32)
        m[pad_ud[0]: H - pad_ud[1] or None,
          pad_lr[0]: W - pad_lr[1] or None] = 1.0
        return m

    mx = mask((0, 0), (0, 1))
    my = mask((0, 1), (0, 0))
    md = mask((1, 1), (1, 1))
    return np.stack([mx, my] + ([md, md] if use_diag else []))


def smoothness_loss(inp: torch.Tensor, target: torch.Tensor,
                    use_diag: bool = True) -> torch.Tensor:
    """inp, target: [B, H, W, 1] -> scalar."""
    B, H, W, C = inp.shape
    if C != 1:
        raise ValueError("smoothness_loss takes one channel")
    filt = torch.as_tensor(_filters(use_diag), dtype=inp.dtype,
                           device=inp.device)

    def grads(x):
        return F.conv2d(x.permute(0, 3, 1, 2), filt, padding=1)

    diff = grads(inp) - grads(target)
    ad = diff.abs()
    huber = torch.where(ad < 1.0, 0.5 * diff * diff, ad - 0.5)
    masks = torch.as_tensor(_masks(H, W, use_diag), dtype=inp.dtype,
                            device=inp.device)
    return (huber * masks[None]).mean()
