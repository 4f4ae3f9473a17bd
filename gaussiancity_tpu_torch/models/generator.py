# -*- coding: utf-8 -*-
"""Gaussian-attribute generator (counterpart of
``gaussiancity_tpu/models/generator.py``; upstream models/generator.py).

Scene encoder (GLOBAL: one code per scene; LOCAL: a feature map sampled
at each point's projection uv) -> positional encoding (hash grid or
sin/cos) -> optional PTv3 features -> per-point attribute MLP.

``compute_dtype="bfloat16"`` casts where the JAX package casts: the
attribute MLP's dense and modulated layers and PTv3 compute in bf16
(``models/layers.py``) with float32 parameters; the scene encoders, the
hash grid, the output heads and the attribute squashing stay float32,
and the attributes come out float32.

The module's mode stands for the JAX ``train`` flag: in training mode
PTv3's BatchNorm uses and updates the batch statistics and drop path is
on (its masks drawn from the ``dp_generator`` that ``forward`` takes).

Public layouts follow the JAX package: projection maps are NHWC and
points [B, N, C]; convolutions permute to NCHW inside.  Submodule and
parameter names mirror the Flax tree (``interop.py`` maps one to the
other).  Initialisation follows torch's defaults, drawn from an explicit
``torch.Generator`` by ``reset_parameters``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gaussiancity_tpu_torch.config import GaussianNetworkConfig
from gaussiancity_tpu_torch.models import ptv3
from gaussiancity_tpu_torch.models.layers import (Dense, compute_dtype,
                                                  leaky_relu)
from gaussiancity_tpu_torch.ops.hash_grid import GridEncoder
from gaussiancity_tpu_torch.utils import profiling


def _reset_torch_default(module: nn.Module,
                         generator: Optional[torch.Generator]) -> None:
    """torch's default Linear / Conv2d init (kaiming-uniform over fan-in
    with a = sqrt(5); bias uniform(+-1/sqrt(fan_in)))."""
    w = module.weight
    fan_in = w.shape[1] * (w[0, 0].numel() if w.dim() > 2 else 1)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        # kaiming_uniform(a=sqrt(5)) has bound sqrt(6 / ((1 + 5) fan_in))
        w.uniform_(-bound, bound, generator=generator)
        if module.bias is not None:
            module.bias.uniform_(-bound, bound, generator=generator)


class SRTConvBlock(nn.Module):
    """conv3x3(s1) -> ReLU -> conv3x3(s2, 2x channels) -> ReLU."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, in_channels, 3, 1, 1, bias=False)
        self.conv2 = nn.Conv2d(in_channels, 2 * in_channels, 3, 2, 1,
                               bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv2(F.relu(self.conv1(x))))


class GlobalEncoder(nn.Module):
    """Scene-level conditioning vector.  proj_hf [B, H, W, 1] and
    proj_seg [B, H, W, n_classes] (NHWC) -> [B, out_channels] in (-1, 1)."""

    def __init__(self, n_classes: int, n_blocks: int, out_channels: int):
        super().__init__()
        self.hf_conv = nn.Conv2d(1, 8, 3, 2, 1)
        self.seg_conv = nn.Conv2d(n_classes, 8, 3, 2, 1)
        self.blocks = nn.ModuleList(
            SRTConvBlock(16 * 2 ** i) for i in range(n_blocks - 1))
        self.fc1 = nn.Linear(16 * 2 ** (n_blocks - 1), 16)
        self.fc2 = nn.Linear(16, out_channels)

    def forward(self, proj_hf: torch.Tensor,
                proj_seg: torch.Tensor) -> torch.Tensor:
        hf = leaky_relu(self.hf_conv(proj_hf.permute(0, 3, 1, 2)))
        seg = leaky_relu(self.seg_conv(proj_seg.permute(0, 3, 1, 2)))
        out = torch.cat([hf, seg], dim=1)
        for block in self.blocks:
            out = leaky_relu(block(out))
        out = out.mean(dim=(2, 3))
        return torch.tanh(self.fc2(leaky_relu(self.fc1(out))))


class TorchConvTranspose(nn.Module):
    """ConvTranspose2d(k, s, p), NCHW.  The weight is [in, out, kh, kw],
    the JAX package's (kh, kw, in, out) kernel transposed and not
    flipped: ``conv_transpose2d`` correlates the stride-dilated input
    with the flipped kernel, padded ``k - 1 - p``, as the JAX layer
    writes it out.  Init as the JAX package's: weight uniform(+-sqrt(3 /
    fan_in)), bias uniform(+-1 / sqrt(fan_in)), fan_in = out * kh * kw."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int, padding: int):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(in_channels, features,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        fan_in = self.weight[0].numel()
        with torch.no_grad():
            b = math.sqrt(3.0 / fan_in)
            self.weight.uniform_(-b, b, generator=generator)
            b = 1.0 / math.sqrt(fan_in)
            self.bias.uniform_(-b, b, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride,
                                  self.padding)


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-5)


class ResConvBlock(nn.Module):
    """Pre-norm residual block, NCHW: three GN -> ReLU -> conv3x3 stages
    of out/2, out/4 and out/4 channels concatenated, plus the input
    (through GN -> ReLU -> conv1x1 when the widths differ)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        c2, c4 = out_channels // 2, out_channels // 4
        self.gn1 = _group_norm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, c2, 3, 1, 1, bias=False)
        self.gn2 = _group_norm(c2)
        self.conv2 = nn.Conv2d(c2, c4, 3, 1, 1, bias=False)
        self.gn3 = _group_norm(c4)
        self.conv3 = nn.Conv2d(c4, c4, 3, 1, 1, bias=False)
        if in_channels != out_channels:
            self.gn_res = _group_norm(in_channels)
            self.conv_res = nn.Conv2d(in_channels, out_channels, 1,
                                      bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(F.relu(self.gn1(x)))
        out2 = self.conv2(F.relu(self.gn2(out1)))
        out3 = self.conv3(F.relu(self.gn3(out2)))
        out3 = torch.cat([out1, out2, out3], dim=1)
        if hasattr(self, "conv_res"):
            x = self.conv_res(F.relu(self.gn_res(x)))
        return out3 + x


class LocalEncoder(nn.Module):
    """Per-pixel conditioning map.  proj_hf [B, H, W, 1] and proj_seg
    [B, H, W, n_classes] (NHWC) -> [B, H, W, out_channels] (NHWC) in
    (-1, 1): 7x7 stride-2 convolutions, ResConvBlocks of 128 channels at
    H/2 and 256, 512 at H/4, two transposed convolutions back to H."""

    def __init__(self, n_classes: int, out_channels: int):
        super().__init__()
        self.hf_conv = nn.Conv2d(1, 32, 7, 2, 3)
        self.seg_conv = nn.Conv2d(n_classes, 32, 7, 2, 3)
        self.norm = _group_norm(64)
        self.block1 = ResConvBlock(64, 128)
        self.block2 = ResConvBlock(128, 256)
        self.block3 = ResConvBlock(256, 512)
        self.up1 = TorchConvTranspose(512, 128, 4, 2, 1)
        self.up2 = TorchConvTranspose(128, 32, 4, 2, 1)
        self.out_conv = nn.Conv2d(32, out_channels, 1)

    def forward(self, proj_hf: torch.Tensor,
                proj_seg: torch.Tensor) -> torch.Tensor:
        hf = self.hf_conv(proj_hf.permute(0, 3, 1, 2))
        seg = self.seg_conv(proj_seg.permute(0, 3, 1, 2))
        out = F.relu(self.norm(torch.cat([hf, seg], dim=1)))
        out = F.avg_pool2d(self.block1(out), 2, 2)
        out = self.block3(self.block2(out))
        out = self.out_conv(self.up2(self.up1(out)))
        return torch.tanh(out).permute(0, 2, 3, 1)


def grid_sample_uv(feat_nhwc: torch.Tensor, uv: torch.Tensor
                   ) -> torch.Tensor:
    """Bilinear sample of [B, H, W, C] at uv ([B, N, 2], [-1, 1] across
    the map, align_corners=True) -> [B, N, C], as the JAX package samples
    it: the left / top corner is clipped into the map and its neighbour
    is that index + 1 clipped, with weights from the unclipped ``x -
    floor(x)``.  Outside [-1, 1] this is not ``F.grid_sample``'s border
    mode: left of the map it mixes the first two columns."""
    B, H, W, C = feat_nhwc.shape
    x = (uv[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (uv[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.long().clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    y0i = y0.long().clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    flat = feat_nhwc.reshape(B * H * W, C)
    base = (torch.arange(B, device=uv.device) * (H * W))[:, None]

    def gather(yi, xi):
        return flat[base + yi * W + xi]

    return (gather(y0i, x0i) * (1 - wx) * (1 - wy)
            + gather(y0i, x1i) * wx * (1 - wy)
            + gather(y1i, x0i) * (1 - wx) * wy
            + gather(y1i, x1i) * wx * wy)


class SinCosEncoder(nn.Module):
    """NeRF-style frequency encoding."""

    def __init__(self, n_freq_bands: int = 8):
        super().__init__()
        self.n_freq_bands = n_freq_bands

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        freq = [2.0 ** i for i in range(self.n_freq_bands)]
        sin = torch.cat([torch.sin(features * fb) for fb in freq], dim=-1)
        cos = torch.cat([torch.cos(features * fb) for fb in freq], dim=-1)
        return torch.cat([sin, cos], dim=-1)


class ModLinear(nn.Module):
    """Affine-modulated linear (StyleGAN2 mod, output_mode, mod_bias):
    y = (x * alpha(z)) @ W^T + bias + beta(z), per point.  With a
    ``dtype``, x, z and every parameter are cast to it first."""

    def __init__(self, in_features: int, out_features: int,
                 style_features: int, use_bias: bool = False,
                 weight_gain: float = 1.0, bias_init_val: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        self.in_features = in_features
        self.style_features = style_features
        self.weight_gain = weight_gain
        self.bias_init_val = bias_init_val
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.weight_alpha = nn.Parameter(
            torch.empty(in_features, style_features))
        self.bias_alpha = nn.Parameter(torch.empty(in_features))
        self.weight_beta = nn.Parameter(
            torch.empty(out_features, style_features))
        self.bias_beta = nn.Parameter(torch.empty(out_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator).mul_(
                self.weight_gain / math.sqrt(self.in_features))
            for w in (self.weight_alpha, self.weight_beta):
                w.normal_(generator=generator).div_(
                    math.sqrt(self.style_features))
            self.bias_alpha.fill_(1.0)
            self.bias_beta.zero_()
            if self.bias is not None:
                self.bias.fill_(self.bias_init_val)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        w, wa, ba, wb, bb, b = (self.weight, self.weight_alpha,
                                self.bias_alpha, self.weight_beta,
                                self.bias_beta, self.bias)
        dt = self.compute_dtype
        if dt is not None:
            x, z, w, wa, ba, wb, bb = (t.to(dt) for t in
                                       (x, z, w, wa, ba, wb, bb))
            b = None if b is None else b.to(dt)
        alpha = z @ wa.T + ba
        beta = z @ wb.T + bb
        y = (x * alpha) @ w.T + beta
        return y if b is None else y + b


class GaussianAttrMLP(nn.Module):
    """Per-attribute MLP with a class-onehot embedding and optional style
    modulation: (pt_feat [B, N, F], onehots [B, N, n_classes], z) ->
    {attr: [B, N, 3 | 1]}.  The hidden layers compute in ``dtype``; the
    output heads and the squashing in float32."""

    def __init__(self, n_classes: int, in_dim: int, z_dim: Optional[int],
                 hidden_dim: int, n_shared_layers: int,
                 factors: Mapping[str, float], n_layers: Mapping[str, int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.z_dim = z_dim
        self.n_shared_layers = n_shared_layers
        self.factors = dict(factors)
        self.n_layers = dict(n_layers)
        self.fc_1 = Dense(in_dim, hidden_dim, dtype=dtype)
        self.fc_m_a = Dense(n_classes, hidden_dim, bias=False, dtype=dtype)

        def layer():
            if z_dim is not None:
                return ModLinear(hidden_dim, hidden_dim, z_dim, dtype=dtype)
            return Dense(hidden_dim, hidden_dim, dtype=dtype)

        for i in range(2, n_shared_layers + 1):
            setattr(self, f"fc_{i}", layer())
        for k in self.factors:
            if k not in ("xyz", "rgb", "scale", "opacity"):
                raise ValueError(f"Unknown key: {k}")
            for i in range(self.n_layers[k]):
                setattr(self, f"fc_{n_shared_layers + 1}_{k}_{i}", layer())
            setattr(self, f"fc_out_{k}",
                    nn.Linear(hidden_dim, 1 if k == "opacity" else 3))

    def _layer(self, name, x, z):
        fc = getattr(self, name)
        return fc(x, z) if self.z_dim is not None else fc(x)

    def forward(self, pt_feat, onehots, z) -> Dict[str, torch.Tensor]:
        with profiling.span("attr_mlp"):
            f = leaky_relu(self.fc_1(pt_feat) + self.fc_m_a(onehots))
            for i in range(2, self.n_shared_layers + 1):
                f = leaky_relu(self._layer(f"fc_{i}", f, z))
            output = {}
            for k in self.factors:
                _f = f
                for i in range(self.n_layers[k]):
                    name = f"fc_{self.n_shared_layers + 1}_{k}_{i}"
                    # upstream quirk (models/generator.py:414): without z the
                    # attribute layers re-consume the shared feature f
                    _f = leaky_relu(self._layer(
                        name, _f if self.z_dim is not None else f, z))
                output[k] = getattr(self, f"fc_out_{k}")(_f.float())
            if "xyz" in self.factors:
                output["xyz"] = ((torch.sigmoid(output["xyz"]) - 0.5)
                                 * self.factors["xyz"])
            if "rgb" in self.factors:
                output["rgb"] = ((torch.sigmoid(output["rgb"]) - 0.5)
                                 * self.factors["rgb"])
            if "scale" in self.factors:
                output["scale"] = 1 + torch.clamp(output["scale"], -1, 1) \
                    * self.factors["scale"]
            if "opacity" in self.factors:
                fo = self.factors["opacity"]
                output["opacity"] = torch.sigmoid(output["opacity"]) * fo \
                    + (1 - fo)
            return output


class Generator(nn.Module):
    """forward(proj_uv [B, N, 2], rel_xyz [B, N, 3], batch_idx, onehots
    [B, N, n_classes], z [B, N, z_dim] | None, proj_hf [B, H, W, 1],
    proj_seg [B, H, W, n_classes], point_mask [B, N], dp_generator) ->
    {attr: tensor}."""

    def __init__(self, cfg: GaussianNetworkConfig, n_classes: int,
                 proj_size: int):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg.compute_dtype)
        if cfg.encoder == "GLOBAL":
            self.proj_encoder = GlobalEncoder(
                n_classes, cfg.global_encoder_n_blocks,
                cfg.encoder_out_dim - 3)
        elif cfg.encoder == "LOCAL":
            self.proj_encoder = LocalEncoder(n_classes,
                                             cfg.encoder_out_dim - 3)
        elif cfg.encoder is None:
            if cfg.encoder_out_dim != 3:
                raise ValueError("encoder=None needs encoder_out_dim == 3")
        else:
            raise ValueError(f"Unknown encoder: {cfg.encoder}")
        if cfg.pos_emd == "HASH_GRID":
            self.pos_encoder = GridEncoder(
                in_channels=cfg.encoder_out_dim,
                n_levels=cfg.hash_grid_n_levels,
                lvl_channels=cfg.hash_grid_level_dim,
                desired_resolution=proj_size,
                base_resolution=cfg.hash_grid_base_res,
                log2_hashmap_size=cfg.hash_grid_map_size)
            feat_dim = self.pos_encoder.output_dim
        elif cfg.pos_emd == "SIN_COS":
            self.pos_encoder = SinCosEncoder(cfg.sin_cos_freq_bends)
            feat_dim = cfg.encoder_out_dim * 2 * cfg.sin_cos_freq_bends
        else:
            raise ValueError(f"Unknown positional encoder: {cfg.pos_emd}")
        if cfg.ptv3.enabled:
            self.pt_net = ptv3.PointTransformerV3(cfg.ptv3,
                                                  in_channels=feat_dim,
                                                  dtype=dt)
            feat_dim += self.pt_net.out_channels
        self.ga_mlp = GaussianAttrMLP(
            n_classes=n_classes, in_dim=feat_dim, z_dim=cfg.z_dim,
            hidden_dim=cfg.mlp_hidden_dim,
            n_shared_layers=cfg.mlp_n_shared_layers,
            factors=cfg.attr_factors, n_layers=cfg.attr_n_layers, dtype=dt)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Redraw every weight from ``generator`` (torch defaults)."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                _reset_torch_default(m, generator)
            elif isinstance(m, (GridEncoder, ModLinear, ptv3.SubMConv,
                                ptv3.MaskedBatchNorm, ptv3.PatchAttention,
                                TorchConvTranspose)):
                m.reset_parameters(generator)
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.reset_parameters()

    def forward(self, proj_uv, rel_xyz, batch_idx, onehots, z,
                proj_hf=None, proj_seg=None, point_mask=None,
                dp_generator: Optional[torch.Generator] = None):
        B, N = rel_xyz.shape[:2]
        if self.cfg.encoder == "GLOBAL":
            with profiling.span("encoder"):
                proj_feat = self.proj_encoder(proj_hf, proj_seg)
                pt_feat = proj_feat[:, None, :].expand(B, N, -1)
        elif self.cfg.encoder == "LOCAL":
            with profiling.span("encoder"):
                pt_feat = grid_sample_uv(
                    self.proj_encoder(proj_hf, proj_seg), proj_uv)
        else:
            pt_feat = rel_xyz.new_zeros((B, N, 0))
        pt_feat = torch.cat([pt_feat, rel_xyz], dim=-1)
        pt_feat = self.pos_encoder(pt_feat)
        if self.cfg.ptv3.enabled:
            pt_feat2 = self.pt_net(pt_feat, rel_xyz, point_mask,
                                   dp_generator)
            pt_feat = torch.cat([pt_feat.to(pt_feat2.dtype), pt_feat2],
                                dim=-1)
        return self.ga_mlp(pt_feat, onehots, z)
