# -*- coding: utf-8 -*-
"""Layers that compute in a chosen dtype while their parameters stay
float32, rounding where the JAX package's Flax layers round
(``TorchDense``, ``nn.Conv(dtype=...)``, ``LayerNormT``).

With ``dtype`` None a layer is the plain float32 torch layer.  With
``torch.bfloat16``:

- ``Dense``: input, kernel and bias are cast to bf16; the product comes
  out in bf16 and the bias is added in bf16 (two roundings, as
  ``x @ kernel`` then ``+ bias`` give in Flax);
- ``conv2d``: the same for a convolution, its bias added after it;
- ``LayerNormT``: statistics in float32, output cast to the dtype;
- a Python scalar meets a bf16 tensor rounded to bf16 first (JAX's weak
  typing), where torch would take it in float32: ``scalar`` rounds it,
  and ``leaky_relu`` uses it;
- ``matmul_f32``: a product of two (bf16) operands accumulated and
  returned in float32, the ``preferred_element_type=jnp.float32`` of the
  JAX package's SubMConv and attention logits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """A config's ``compute_dtype`` string -> the layers' dtype (None for
    float32)."""
    if name not in DTYPES:
        raise ValueError(f"unknown compute_dtype {name!r}")
    return DTYPES[name]


def scalar(value: float, dtype: Optional[torch.dtype]) -> float:
    """``value`` rounded to ``dtype`` (a Python float; unchanged for
    float32), as JAX rounds a Python scalar that meets a tensor."""
    if dtype is None or dtype == torch.float32:
        return value
    return float(torch.tensor(value, dtype=dtype))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``where(x >= 0, x, slope * x)`` with the slope in ``x``'s dtype."""
    if x.dtype == torch.float32:
        return F.leaky_relu(x, negative_slope=slope)
    return torch.where(x >= 0, x, x * scalar(slope, x.dtype))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in float32.  The operands'
    values are exact in float32, so the products are too."""
    return a.float() @ b.float()


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: Optional[torch.dtype],
           stride=1, padding=0) -> torch.Tensor:
    """NCHW convolution in ``dtype`` (None: float32 with the bias fused)."""
    if dtype is None:
        return F.conv2d(x, weight, bias, stride, padding)
    y = F.conv2d(x.to(dtype), weight.to(dtype), None, stride, padding)
    return y if bias is None else y + bias.to(dtype)[:, None, None]


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (see the module docstring)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return F.linear(x, self.weight, self.bias)
        y = x.to(dt) @ self.weight.to(dt).T
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNormT(nn.LayerNorm):
    """LayerNorm (eps 1e-5) with float32 statistics, output in ``dtype``.
    In float32 it is torch's fused LayerNorm.  With a ``dtype`` the
    statistics and the normalisation are Flax's ``LayerNorm``'s, op for
    op: var = max(mean(x^2) - mean(x)^2, 0), y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias, so that the bf16 output rounds
    from the float32 value the JAX package rounds."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__(channels, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias
        return y.to(self.compute_dtype)
