# -*- coding: utf-8 -*-
"""The two-model frame sharded over the ranks of a process group
(counterpart of ``gaussiancity_tpu/parallel/sharded_infer.py``; upstream
scripts/inference.py:426-507 runs the generators on one GPU).

Attribute prediction is sharded over the point axis of each class's
slab: rank r keeps rows ``[r * S / world, (r + 1) * S / world)`` of a
slab of S rows.

- The REST generator (hash grid or LOCAL encoder, scene code, MLP) is
  pointwise, so each rank evaluates only its own rows.
- PTv3 is not: serialisation, pooling and patch attention span the whole
  slab.  JAX stays exact there because XLA's partitioner inserts the
  collectives; here each rank evaluates the whole BLDG slab, with its
  point mask, and keeps its own rows.

The rows feed ``make_sharded_rasterizer``: each rank's shard is its rows
of each slab in turn, so the gathered Gaussians are in rank-major order
where the single-device frame has them class by class.  Binning breaks
exact depth ties by that order; everything else is the same frame.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from gaussiancity_tpu_torch.camera import CameraParams
from gaussiancity_tpu_torch.config import RasterizerConfig
from gaussiancity_tpu_torch.ops.rasterizer.api import unpack_points14
from gaussiancity_tpu_torch.parallel.sharded_raster import (
    ShardedRenderOutput, make_sharded_rasterizer)

__all__ = ["make_sharded_frame", "unpack_points14"]


def make_sharded_frame(pipe, cam: CameraParams, cfg: RasterizerConfig,
                       group=None):
    """Returns ``frame(buckets, proj_hf, proj_seg, style_lut, bg) ->
    ShardedRenderOutput`` (the image [3, H, W] the same on every rank).
    ``pipe`` is an ``InferencePipeline``; ``buckets`` maps each of its
    models to (pts9 [S, 9] on the rank's device, count): the first
    ``count`` rows are real, S divides over the ranks."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    raster = make_sharded_rasterizer(cam, cfg, group)

    @torch.no_grad()
    def frame(buckets: Dict[str, Tuple[torch.Tensor, int]], proj_hf,
              proj_seg, style_lut, bg) -> ShardedRenderOutput:
        gs_parts, mask_parts = [], []
        for name, module in pipe.models.items():
            pts9, count = buckets[name]
            slab = pts9.shape[0]
            if slab % world:
                raise ValueError(f"{name} slab {slab} must divide over "
                                 f"{world} ranks")
            lo, hi = rank * slab // world, (rank + 1) * slab // world
            mask = torch.arange(slab, device=pts9.device) < count
            if module.cfg.ptv3.enabled:
                gs = pipe.predict_attrs_single(
                    name, pts9, proj_hf, proj_seg, None, style_lut,
                    pts_mask=mask)[lo:hi]
            else:
                gs = pipe.predict_attrs_single(
                    name, pts9[lo:hi], proj_hf, proj_seg, None, style_lut,
                    pts_mask=mask[lo:hi])
            gs_parts.append(gs)
            mask_parts.append(mask[lo:hi])
        means, opacity, scales, quats, colors = unpack_points14(
            torch.cat(gs_parts))
        return raster(means, opacity, scales, quats, colors,
                      torch.cat(mask_parts), bg)

    return frame
