# -*- coding: utf-8 -*-
"""Gaussian-attribute generator (counterpart of
``gaussiancity_tpu/models/generator.py``; upstream models/generator.py).

Scene encoder -> positional encoding (hash grid or sin/cos) -> per-point
attribute MLP.  This slice covers the REST generator: the GLOBAL encoder,
the hash grid, no PTv3.  ``encoder="LOCAL"``, ``ptv3.enabled`` and the
bfloat16 compute dtype raise ``NotImplementedError``.

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
from gaussiancity_tpu_torch.ops.hash_grid import GridEncoder


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


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
        hf = _leaky_relu(self.hf_conv(proj_hf.permute(0, 3, 1, 2)))
        seg = _leaky_relu(self.seg_conv(proj_seg.permute(0, 3, 1, 2)))
        out = torch.cat([hf, seg], dim=1)
        for block in self.blocks:
            out = _leaky_relu(block(out))
        out = out.mean(dim=(2, 3))
        return torch.tanh(self.fc2(_leaky_relu(self.fc1(out))))


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
    y = (x * alpha(z)) @ W^T + bias + beta(z), per point."""

    def __init__(self, in_features: int, out_features: int,
                 style_features: int, use_bias: bool = False,
                 weight_gain: float = 1.0, bias_init_val: float = 0.0):
        super().__init__()
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
        alpha = z @ self.weight_alpha.T + self.bias_alpha
        beta = z @ self.weight_beta.T + self.bias_beta
        y = (x * alpha) @ self.weight.T + beta
        return y if self.bias is None else y + self.bias


class GaussianAttrMLP(nn.Module):
    """Per-attribute MLP with a class-onehot embedding and optional style
    modulation: (pt_feat [B, N, F], onehots [B, N, n_classes], z) ->
    {attr: [B, N, 3 | 1]}."""

    def __init__(self, n_classes: int, in_dim: int, z_dim: Optional[int],
                 hidden_dim: int, n_shared_layers: int,
                 factors: Mapping[str, float], n_layers: Mapping[str, int]):
        super().__init__()
        self.z_dim = z_dim
        self.n_shared_layers = n_shared_layers
        self.factors = dict(factors)
        self.n_layers = dict(n_layers)
        self.fc_1 = nn.Linear(in_dim, hidden_dim)
        self.fc_m_a = nn.Linear(n_classes, hidden_dim, bias=False)

        def layer():
            if z_dim is not None:
                return ModLinear(hidden_dim, hidden_dim, z_dim)
            return nn.Linear(hidden_dim, hidden_dim)

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
        f = _leaky_relu(self.fc_1(pt_feat) + self.fc_m_a(onehots))
        for i in range(2, self.n_shared_layers + 1):
            f = _leaky_relu(self._layer(f"fc_{i}", f, z))
        output = {}
        for k in self.factors:
            _f = f
            for i in range(self.n_layers[k]):
                name = f"fc_{self.n_shared_layers + 1}_{k}_{i}"
                # upstream quirk (models/generator.py:414): without z the
                # attribute layers re-consume the shared feature f
                _f = _leaky_relu(self._layer(
                    name, _f if self.z_dim is not None else f, z))
            output[k] = getattr(self, f"fc_out_{k}")(_f)
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
    proj_seg [B, H, W, n_classes], point_mask [B, N]) -> {attr: tensor}."""

    def __init__(self, cfg: GaussianNetworkConfig, n_classes: int,
                 proj_size: int):
        super().__init__()
        self.cfg = cfg
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                "the PyTorch port's generator computes in float32 only")
        if cfg.encoder == "GLOBAL":
            self.proj_encoder = GlobalEncoder(
                n_classes, cfg.global_encoder_n_blocks,
                cfg.encoder_out_dim - 3)
        elif cfg.encoder == "LOCAL":
            raise NotImplementedError(
                "LocalEncoder is not ported yet (a later slice)")
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
            raise NotImplementedError(
                "PTv3 is not ported yet (the BLDG slice)")
        self.ga_mlp = GaussianAttrMLP(
            n_classes=n_classes, in_dim=feat_dim, z_dim=cfg.z_dim,
            hidden_dim=cfg.mlp_hidden_dim,
            n_shared_layers=cfg.mlp_n_shared_layers,
            factors=cfg.attr_factors, n_layers=cfg.attr_n_layers)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Redraw every weight from ``generator`` (torch defaults)."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                _reset_torch_default(m, generator)
            elif isinstance(m, (GridEncoder, ModLinear)):
                m.reset_parameters(generator)

    def forward(self, proj_uv, rel_xyz, batch_idx, onehots, z,
                proj_hf=None, proj_seg=None, point_mask=None):
        B, N = rel_xyz.shape[:2]
        if self.cfg.encoder == "GLOBAL":
            proj_feat = self.proj_encoder(proj_hf, proj_seg)
            pt_feat = proj_feat[:, None, :].expand(B, N, -1)
        else:
            pt_feat = rel_xyz.new_zeros((B, N, 0))
        pt_feat = torch.cat([pt_feat, rel_xyz], dim=-1)
        return self.ga_mlp(self.pos_encoder(pt_feat), onehots, z)
