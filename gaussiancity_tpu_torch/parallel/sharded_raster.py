# -*- coding: utf-8 -*-
"""Band-sharded rasterization over the ranks of a process group
(counterpart of ``gaussiancity_tpu/parallel/sharded_raster.py``).

Each rank preprocesses its own shard of the Gaussians, one gather carries
the 12 floats per Gaussian that binning and the blend read (the blend's
ten attribute rows, depth and the valid flag), and each rank bins and
blends its own band of image rows: band r covers sensor rows
``[r * band_h, (r + 1) * band_h)`` with ``band_h = ceil(H / (tile_h *
world)) * tile_h``, so any sensor height shards; the last band's rows
past H are rendered and cropped.  The band renders in sensor coordinates
(``rasterize_preprocessed``'s window), so each band pixel equals the same
pixel of a full render.  The bands are gathered and every rank returns
the same [3, H, W] image.

Backward: the image gather returns each rank its own band's rows of the
image's cotangent, and the attribute gather all-reduces the full
cotangent and returns the rank's own rows: the sum over ranks that JAX's
reduce-scatter takes, with a collective gloo has.  The caller's loss is
taken to be the same on every rank (the image is); ``bg``'s gradient is
the sum of the bands'.  As in the JAX band, the band's backward is exact:
it blends with no slot budget (``grad_capacity`` and ``grad_budget`` 0).
The binning counters of the bands are summed and returned beside the
image."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from gaussiancity_tpu_torch.camera import CameraParams
from gaussiancity_tpu_torch.config import RasterizerConfig
from gaussiancity_tpu_torch.ops.rasterizer import preprocess
from gaussiancity_tpu_torch.ops.rasterizer.api import rasterize_preprocessed
from gaussiancity_tpu_torch.parallel.mesh import all_gather_rows


class ShardedRenderOutput(NamedTuple):
    image: torch.Tensor  # [3, H, W], the same on every rank
    # int64 scalars summed over the bands, as RenderOutput's
    n_dropped_pairs: torch.Tensor
    n_truncated: torch.Tensor
    n_grad_truncated: torch.Tensor  # 0: the band backward has no budget


class _GatherRows(torch.autograd.Function):
    """Forward: gather every rank's [n, C] rows.  Backward: the sum over
    the ranks of the [world * n, C] cotangent, this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.n:(r + 1) * ctx.n], None


class _GatherBands(torch.autograd.Function):
    """Forward: [3, band_h, W] bands -> [3, world * band_h, W].  Backward:
    this band's rows of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, band, group):
        ctx.group, ctx.band_h = group, band.shape[1]
        c, h, w = band.shape
        rows = all_gather_rows(band.reshape(1, -1), group)
        return rows.reshape(-1, c, h, w).permute(1, 0, 2, 3).reshape(
            c, -1, w)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[:, r * ctx.band_h:(r + 1) * ctx.band_h].contiguous(), None


class _Replicated(torch.autograd.Function):
    """An input every rank holds alike (``bg``): identity forward; the
    backward sums the ranks' cotangents, as shard_map transposes a
    replicated input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def band_height(img_h: int, tile_h: int, world: int) -> int:
    """Rows of one band: the sensor's tile rows split over the ranks,
    rounded up."""
    return -(-img_h // (tile_h * world)) * tile_h


def make_sharded_rasterizer(cam: CameraParams,
                            cfg: RasterizerConfig = RasterizerConfig(),
                            group=None):
    """Returns ``render(means3d, opacities, scales, quats, colors, valid,
    bg) -> ShardedRenderOutput``, each argument but ``bg`` this rank's shard
    of the Gaussians (rank r holds rows ``[r * n, (r + 1) * n)`` of the
    whole, n the same on every rank, as JAX's ``P(axis)`` requires).
    Differentiable with respect to the shard's means, opacities, scales,
    quats, colours and ``bg``."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    H, W = cam.img_h, cam.img_w
    band_h = band_height(H, cfg.tile_h, world)
    band_cfg = cfg.replace(grad_capacity=0, grad_budget=0)

    def render(means3d, opacities, scales, quats, colors, valid, bg):
        prep = preprocess.preprocess(means3d, opacities, scales, quats,
                                     colors, valid, cam, near_z=cfg.near_z)
        packed = torch.cat([prep.attrs10(), torch.stack(
            [prep.depth, prep.valid.float()], -1).float()], -1)
        g = _GatherRows.apply(packed, group)
        gprep = preprocess.Preprocessed(
            mx=g[:, 0], my=g[:, 1], conic_a=g[:, 2], conic_b=g[:, 3],
            conic_c=g[:, 4], opacity=g[:, 5], color_r=g[:, 6],
            color_g=g[:, 7], color_b=g[:, 8], depth=g[:, 10],
            radius=g[:, 9].detach().to(torch.int32), valid=g[:, 11] > 0.5)
        band = rasterize_preprocessed(
            gprep, _Replicated.apply(bg, group), H, W, band_cfg,
            window=(0, rank * band_h, W, band_h))
        counts = torch.stack([band.n_dropped_pairs, band.n_truncated,
                              band.n_grad_truncated]).long()
        dist.all_reduce(counts, group=group)
        return ShardedRenderOutput(
            _GatherBands.apply(band.image, group)[:, :H], *counts.unbind())

    return render
