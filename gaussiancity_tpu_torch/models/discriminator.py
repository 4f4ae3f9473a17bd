# -*- coding: utf-8 -*-
"""FPN discriminator with spectral-norm convs (counterpart of
``gaussiancity_tpu/models/discriminator.py``; upstream
models/discriminator.py:14-221).

Public layouts follow the JAX package: images, seg maps and masks are NHWC,
and so are the outputs ``{"pred": [B, H/4, W/4, n_classes + 1], "label":
[B, H/4, W/4, n_classes]}``; convolutions run NCHW inside.

Spectral norm follows flax's ``SpectralNorm`` (the JAX package's), not
``torch.nn.utils.spectral_norm``:

- the kernel, in flax's HWIO layout, is flattened to [H * W * I, O];
- ``u`` [1, O] and ``sigma`` are buffers (flax's ``batch_stats``);
- every call runs one power step, ``l2_normalize(x) = x * rsqrt(sum(x^2)
  + 1e-12)``, and stores the new ``u`` and ``sigma`` (the train step's
  ``update_sn=True`` on every application); ``u`` and ``v`` are detached
  and the gradient flows through ``sigma = v W u^T``.

With a compute ``dtype`` (bfloat16, the JAX package's
``train.compute_dtype``) the spectral-norm convolutions compute in it:
the power iteration and the division by sigma stay float32 (flax's
``SpectralNorm`` works on the float32 parameters), then input, kernel and
bias are cast and the bias is added after the convolution, as
``nn.Conv(dtype=...)`` does.  The FPN's upsampling follows the features'
dtype, and the output conv runs on the float32 copy of its input.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussiancity_tpu_torch.models.layers import conv2d, leaky_relu
from gaussiancity_tpu_torch.utils import profiling

SN_EPS = 1e-12


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


class SNConv(nn.Module):
    """Spectral-norm conv (3x3 with symmetric padding 1, or 1x1) followed
    by a leaky ReLU(0.2), computing in ``dtype``."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.stride = stride
        self.padding = 1 if kernel > 1 else 0
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("u", torch.empty(1, features))
        self.register_buffer("sigma", torch.ones(()))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """torch's default conv init and a N(0, 1) power-iteration
        vector, drawn from ``generator``."""
        fan_in = self.weight[0].numel()
        bound = 1.0 / math.sqrt(fan_in)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)
            self.u.normal_(generator=generator)
            self.sigma.fill_(1.0)

    def normalized_weight(self) -> torch.Tensor:
        """The kernel divided by its power-iteration spectral norm; the
        new ``u`` and ``sigma`` are stored."""
        O, I, kh, kw = self.weight.shape
        w_mat = self.weight.permute(2, 3, 1, 0).reshape(kh * kw * I, O)
        with torch.no_grad():
            v0 = _l2_normalize(self.u @ w_mat.T)
            u0 = _l2_normalize(v0 @ w_mat)
        sigma = ((v0 @ w_mat) @ u0.T)[0, 0]
        w_mat = w_mat / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        with torch.no_grad():
            self.u.copy_(u0)
            self.sigma.copy_(sigma)
        return w_mat.reshape(kh, kw, I, O).permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(x, self.normalized_weight(), self.bias,
                   self.compute_dtype, self.stride, self.padding)
        return leaky_relu(y)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of ``jax.image.resize``'s linear
    method along one axis (half-pixel centres, antialiased when
    shrinking, jax/_src/image/scale.py compute_weight_mat)."""
    inv_scale = np.float32(n_in / n_out)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + 0.5) * inv_scale
              - 0.5).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / kernel_scale
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_linear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCHW -> [N, C, *size], the JAX package's ``jax.image.resize(...,
    "linear"/"bilinear")`` (separable, half-pixel, antialiased)."""
    H, W = x.shape[-2:]
    wh = torch.as_tensor(_resize_weights(H, size[0]), device=x.device,
                         dtype=x.dtype)
    ww = torch.as_tensor(_resize_weights(W, size[1]), device=x.device,
                         dtype=x.dtype)
    return torch.einsum("nchw,hH,wW->ncHW", x, wh, ww)


def _up2x(x: torch.Tensor, target_hw) -> torch.Tensor:
    """Bilinear upsample of the coarser FPN level to the lateral
    feature's spatial size."""
    return resize_linear(x, tuple(target_hw))


def smooth_interp(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Area-downsample an NCHW one-hot seg map to ``size`` and re-onehot
    it by argmax (first maximum on ties)."""
    H, W = x.shape[-2:]
    th, tw = size
    if H % th == 0 and W % tw == 0:
        y = F.avg_pool2d(x, (H // th, W // tw))
    else:
        y = resize_linear(x, size)
    return F.one_hot(y.argmax(dim=1), x.shape[1]).permute(0, 3, 1, 2).to(
        x.dtype)


class Discriminator(nn.Module):
    """N+1-class patch discriminator FPN.  forward(images [B, H, W, 3],
    seg_maps [B, H, W, n_classes], masks [B, H, W, 1]) -> {"pred", "label"}
    (NHWC); "pred" is float32 whatever the compute ``dtype``."""

    def __init__(self, n_channel_base: int = 128, n_classes: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        nc = n_channel_base
        self.n_classes = n_classes
        dt = dict(dtype=dtype)
        self.enc1 = SNConv(3, nc, 3, 2, **dt)
        self.enc2 = SNConv(nc, 2 * nc, 3, 2, **dt)
        self.enc3 = SNConv(2 * nc, 4 * nc, 3, 2, **dt)
        self.enc4 = SNConv(4 * nc, 8 * nc, 3, 2, **dt)
        self.enc5 = SNConv(8 * nc, 8 * nc, 3, 2, **dt)
        self.lat5 = SNConv(8 * nc, 4 * nc, 1, 1, **dt)
        self.lat4 = SNConv(8 * nc, 4 * nc, 1, 1, **dt)
        self.lat3 = SNConv(4 * nc, 4 * nc, 1, 1, **dt)
        self.lat2 = SNConv(2 * nc, 4 * nc, 1, 1, **dt)
        self.final2 = SNConv(4 * nc, 2 * nc, 3, 1, **dt)
        self.output = nn.Conv2d(2 * nc, n_classes + 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Redraw every weight and power-iteration vector from
        ``generator`` (torch's default conv init)."""
        for m in self.modules():
            if isinstance(m, SNConv):
                m.reset_parameters(generator)
        bound = 1.0 / math.sqrt(self.output.weight[0].numel())
        with torch.no_grad():
            self.output.weight.uniform_(-bound, bound, generator=generator)
            self.output.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, images: torch.Tensor, seg_maps: torch.Tensor,
                masks: torch.Tensor) -> Dict[str, torch.Tensor]:
        with profiling.span("disc"):
            x = (images * masks).permute(0, 3, 1, 2)
            f11 = self.enc1(x)
            f12 = self.enc2(f11)
            f13 = self.enc3(f12)
            f14 = self.enc4(f13)
            f15 = self.enc5(f14)
            f25 = self.lat5(f15)
            f24 = _up2x(f25, f14.shape[-2:]) + self.lat4(f14)
            f23 = _up2x(f24, f13.shape[-2:]) + self.lat3(f13)
            f22 = _up2x(f23, f12.shape[-2:]) + self.lat2(f12)
            f32 = self.final2(f22)
            pred = leaky_relu(self.output(f32.float()))
            label = smooth_interp((seg_maps * masks).permute(0, 3, 1, 2),
                                  f32.shape[-2:])
            return {"pred": pred.permute(0, 2, 3, 1),
                    "label": label.permute(0, 2, 3, 1)}
