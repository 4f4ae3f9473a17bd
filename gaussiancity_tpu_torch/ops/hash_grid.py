# -*- coding: utf-8 -*-
"""Multiresolution hash-grid positional encoding, forward (counterpart of
``gaussiancity_tpu/ops/hash_grid.py``; upstream grid_encoder,
grid_encoder_ext.cu:51-249).

The table is ``[L, R_max, C]``, one padded row block per level with
level-local row indices, exactly as in the JAX package, so parameters
convert one to one.  Semantics:

- inputs in [-bound, bound] map to [0, 1]; out-of-bound points give 0;
- level scale ``2^(l * log2(s)) * base - 1``, resolution ceil(scale) + 1;
- dense indexing while the level's corner lattice fits its table, else
  the XOR-prime hash (uint32 arithmetic, emulated in int64 with a
  ``& 0xFFFFFFFF`` after each multiply);
- align_corners=False: pos = x * scale + 0.5.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_U32 = 0xFFFFFFFF


def level_params(in_channels: int, n_levels: int, base_resolution: int,
                 desired_resolution: int, log2_hashmap_size: int
                 ) -> Tuple[float, Sequence[int], Sequence[int],
                            Sequence[bool], int]:
    """Static per-level layout: (per_level_scale, offsets, resolutions,
    hashed flags, total_rows)."""
    per_level_scale = 2.0 ** (
        math.log2(desired_resolution / base_resolution) / (n_levels - 1))
    max_params = 2 ** log2_hashmap_size
    offsets, resolutions, hashed = [], [], []
    offset = 0
    S = math.log2(per_level_scale)
    for lvl in range(n_levels):
        scale = (2.0 ** (lvl * S)) * base_resolution - 1.0
        resolution = int(np.ceil(scale)) + 1
        corners = (resolution + 1) ** in_channels
        params_in_level = int(np.ceil(min(max_params, corners) / 8) * 8)
        offsets.append(offset)
        resolutions.append(resolution)
        hashed.append(corners > params_in_level)
        offset += params_in_level
    return per_level_scale, offsets, resolutions, hashed, offset


def _level_rows(offsets, total):
    bounds = list(offsets) + [total]
    return [bounds[l + 1] - bounds[l] for l in range(len(offsets))]


def table_shape(in_channels: int, n_levels: int, base_resolution: int,
                desired_resolution: int, log2_hashmap_size: int,
                lvl_channels: int) -> Tuple[int, int, int]:
    """The [L, R_max, C] embedding-table shape."""
    _, offsets, _, _, total = level_params(
        in_channels, n_levels, base_resolution, desired_resolution,
        log2_hashmap_size)
    return n_levels, max(_level_rows(offsets, total)), lvl_channels


def corner_bits(D: int, device=None) -> torch.Tensor:
    """[2^D, D] corner offsets (bit d of the corner index)."""
    c = torch.arange(1 << D, device=device)
    return (c[:, None] >> torch.arange(D, device=device)[None, :]) & 1


def hash_u32(pc: torch.Tensor) -> torch.Tensor:
    """XOR-prime hash of int64 lattice points [..., D] as the uint32 value
    (held in int64) that wrapping uint32 arithmetic gives."""
    idx = torch.zeros_like(pc[..., 0])
    for d in range(pc.shape[-1]):
        idx = idx ^ ((pc[..., d] * _PRIMES[d]) & _U32)
    return idx


def corner_indices(grid: torch.Tensor, hashed: bool, resolution: int,
                   rows: int) -> torch.Tensor:
    """Level-local table rows [2^D, N] of the 2^D corners of each point's
    cell; ``grid`` [N, D] int64 holds floor(pos)."""
    D = grid.shape[1]
    pc = grid[None] + corner_bits(D, grid.device)[:, None, :]
    if hashed:
        idx = hash_u32(pc)
    else:
        idx = torch.zeros_like(pc[..., 0])
        stride = 1
        for d in range(D):
            idx = idx + pc[..., d] * stride
            stride *= resolution + 1
    return idx % rows


def hash_encode(inputs: torch.Tensor, embeddings: torch.Tensor,
                in_channels: int, n_levels: int, base_resolution: int,
                desired_resolution: int, log2_hashmap_size: int,
                bound: float = 1.0) -> torch.Tensor:
    """inputs [N, D] -> [N, n_levels * C] (multilinear over the 2^D
    corners of each level; one [2^D, N, C] gather per level)."""
    D = in_channels
    _, offsets, resolutions, hashed, total = level_params(
        D, n_levels, base_resolution, desired_resolution, log2_hashmap_size)
    level_rows = _level_rows(offsets, total)
    S = math.log2(desired_resolution / base_resolution) / (n_levels - 1)
    x01 = (inputs + bound) / (2.0 * bound)
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    bits = corner_bits(D, inputs.device)
    outs = []
    for lvl in range(n_levels):
        scale = (2.0 ** (lvl * S)) * base_resolution - 1.0
        pos = x01 * scale + 0.5  # [N, D]
        g = torch.floor(pos)
        frac = pos - g
        w = torch.ones((1 << D, inputs.shape[0]), dtype=frac.dtype,
                       device=frac.device)
        for d in range(D):
            w = w * torch.where(bits[:, None, d] == 1, frac[None, :, d],
                                1.0 - frac[None, :, d])
        idx = corner_indices(g.long(), hashed[lvl], resolutions[lvl],
                             level_rows[lvl])
        vals = embeddings[lvl][idx]  # [2^D, N, C]
        outs.append((vals * w[..., None]).sum(dim=0))
    out = torch.cat(outs, dim=-1)
    return torch.where(oob[:, None], torch.zeros_like(out), out)


class GridEncoder(nn.Module):
    """Module owning the hash table (init uniform(-1e-4, 1e-4))."""

    def __init__(self, in_channels: int, n_levels: int = 16,
                 lvl_channels: int = 8, desired_resolution: int = 2048,
                 base_resolution: int = 16, log2_hashmap_size: int = 19):
        super().__init__()
        self.in_channels = in_channels
        self.n_levels = n_levels
        self.lvl_channels = lvl_channels
        self.desired_resolution = desired_resolution
        self.base_resolution = base_resolution
        self.log2_hashmap_size = log2_hashmap_size
        self.embeddings = nn.Parameter(torch.empty(table_shape(
            in_channels, n_levels, base_resolution, desired_resolution,
            log2_hashmap_size, lvl_channels)))
        self.reset_parameters()

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.lvl_channels

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        with torch.no_grad():
            self.embeddings.uniform_(-1e-4, 1e-4, generator=generator)

    def forward(self, inputs: torch.Tensor,
                bound: float = 1.0) -> torch.Tensor:
        prefix = inputs.shape[:-1]
        out = hash_encode(
            inputs.reshape(-1, self.in_channels), self.embeddings,
            self.in_channels, self.n_levels, self.base_resolution,
            self.desired_resolution, self.log2_hashmap_size, bound)
        return out.reshape(*prefix, self.output_dim)
