# -*- coding: utf-8 -*-
"""Tile binning: preprocessed Gaussians -> per-tile, front-to-back slot
lists (counterpart of ``gaussiancity_tpu/ops/rasterizer/binning.py``).

Dynamic, like upstream's InclusiveSum -> duplicateWithKeys -> radix sort
-> identifyTileRanges (rasterizer_impl.cu:64-283): every Gaussian is
duplicated into every tile of its rect (no per-Gaussian cap, so
``n_dropped_pairs`` is 0 by construction), the (tile, depth rank) keys
are sorted, and each tile keeps its nearest ``tile_capacity`` entries.
Slot order is tile, then depth, then original index on depth ties.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gaussiancity_tpu_torch.ops.rasterizer.preprocess import Preprocessed


class TileBins(NamedTuple):
    gauss_index: torch.Tensor  # [T, K] int32 index into the Gaussians
    kmask: torch.Tensor  # [T, K] bool: slot holds a real entry
    counts: torch.Tensor  # [T] int32
    n_dropped_pairs: torch.Tensor  # scalar int32, always 0 here
    n_truncated: torch.Tensor  # scalar int32: entries beyond capacity


def tile_grid(img_h: int, img_w: int, tile_h: int, tile_w: int):
    return -(-img_h // tile_h), -(-img_w // tile_w)


def compute_rects_c(mx, my, radius, valid, img_h, img_w, tile_h, tile_w,
                    gate16: bool = False,
                    gate_origin: Optional[Tuple[float, float]] = None):
    """Tile rects of each Gaussian (upstream getRect, auxiliary.h:36-46).

    ``gate16`` covers the sensor-16x16-block-aligned bbox instead of the
    raw pixel bbox, so that every pixel the blend's reference gate lets a
    Gaussian touch lies in a binned tile; ``gate_origin`` is the sensor
    position of window pixel 0."""
    n_ty, n_tx = tile_grid(img_h, img_w, tile_h, tile_w)
    r = radius.to(mx.dtype)

    def lo_tile(v, size, n_max):
        return torch.clamp(torch.floor(v / size), 0, n_max).to(torch.int32)

    def hi_tile(v, size, n_max):
        return torch.clamp(torch.floor((v + size - 1) / size), 0,
                           n_max).to(torch.int32)

    if gate16:
        ox, oy = gate_origin if gate_origin is not None else (0.0, 0.0)
        lo_x = torch.floor((mx + ox - r) * 0.0625) * 16.0 - ox
        hi_x = torch.floor((mx + ox + r + 15.0) * 0.0625) * 16.0 - ox
        lo_y = torch.floor((my + oy - r) * 0.0625) * 16.0 - oy
        hi_y = torch.floor((my + oy + r + 15.0) * 0.0625) * 16.0 - oy
    else:
        lo_x, hi_x = mx - r, mx + r
        lo_y, hi_y = my - r, my + r
    x_min, y_min = lo_tile(lo_x, tile_w, n_tx), lo_tile(lo_y, tile_h, n_ty)
    x_max, y_max = hi_tile(hi_x, tile_w, n_tx), hi_tile(hi_y, tile_h, n_ty)
    area = (x_max - x_min) * (y_max - y_min)
    valid = valid & (area > 0)
    return (x_min, y_min, x_max, y_max,
            torch.where(valid, area, torch.zeros_like(area)), valid)


def bin_gaussians(prep: Preprocessed, img_h: int, img_w: int,
                  tile_h: int = 32, tile_w: int = 32,
                  tile_capacity: int = 1024, gate16: bool = False,
                  gate_origin: Optional[Tuple[float, float]] = None
                  ) -> TileBins:
    """Build the per-tile slot lists, nearest first."""
    mx, my = prep.mx.detach(), prep.my.detach()
    depth = prep.depth.detach()
    dev = mx.device
    n_ty, n_tx = tile_grid(img_h, img_w, tile_h, tile_w)
    T = n_ty * n_tx
    N = mx.shape[0]
    K = tile_capacity

    x_min, y_min, x_max, y_max, area, _ = compute_rects_c(
        mx, my, prep.radius, prep.valid, img_h, img_w, tile_h, tile_w,
        gate16=gate16, gate_origin=gate_origin)
    area = area.long()
    gid = torch.repeat_interleave(torch.arange(N, device=dev), area)
    n_pairs = gid.shape[0]
    # pair j of a Gaussian covers its rect row-major (y-major, like
    # duplicateWithKeys)
    first = torch.cumsum(area, 0) - area
    j = torch.arange(n_pairs, device=dev) - first[gid]
    rw = (x_max - x_min).long().clamp(min=1)[gid]
    tile = ((y_min.long()[gid] + j // rw) * n_tx
            + (x_min.long()[gid] + j % rw))

    # one int64 key per pair: (tile, global depth rank); the stable depth
    # argsort breaks depth ties by original index
    rank = torch.empty(N, dtype=torch.long, device=dev)
    rank[torch.argsort(depth, stable=True)] = torch.arange(N, device=dev)
    key_s, order = torch.sort(tile * max(N, 1) + rank[gid])
    tile_s = key_s // max(N, 1)
    idx_s = gid[order].to(torch.int32)

    full_counts = torch.bincount(tile_s, minlength=T)
    starts = torch.cumsum(full_counts, 0) - full_counts
    counts = torch.clamp(full_counts, max=K)
    n_truncated = torch.clamp(full_counts - K, min=0).sum()

    k = torch.arange(K, device=dev)
    kmask = k[None, :] < counts[:, None]
    idx_pad = torch.cat([idx_s, torch.zeros(K, dtype=torch.int32,
                                            device=dev)])
    gauss_index = idx_pad[starts[:, None] + k[None, :]]
    gauss_index = torch.where(kmask, gauss_index,
                              torch.zeros_like(gauss_index))
    return TileBins(
        gauss_index=gauss_index.contiguous(),
        kmask=kmask,
        counts=counts.to(torch.int32),
        n_dropped_pairs=torch.zeros((), dtype=torch.int32, device=dev),
        n_truncated=n_truncated.to(torch.int32),
    )
