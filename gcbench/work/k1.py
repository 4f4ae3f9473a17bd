"""Kernel K1's work on a frame: a frozen copy of the counting that
``chip_smoke.py`` puts in K1's bound, on the reference's own preprocess,
binning and plain blend of the same Gaussians (``blend.blend_work`` is
frozen in the reference's ``blend.py``).

Operations: 12 per (pixel, slot) pair tested where the 16x16 gate holds
(offsets, power, one test), 14 more per eligible pair (exp, alpha and
clamp, the alpha and transmittance tests, weight, colour) and 16 per
(sub-tile, slot) cull test.  Bytes: each touched Gaussian's 10 floats,
each slot index and tile count read once, the image, final T and
n_contrib written once."""

from __future__ import annotations

from typing import Dict

import torch

from gcbench.reference.gct.ops.rasterizer import binning, blend, preprocess
from gcbench.reference.gct.ops.rasterizer.api import unpack_points14

FLOP_PER_GATED = 12
FLOP_PER_ELIGIBLE = 14
CULL_OPS = 16


@torch.no_grad()
def frame_work(gs: torch.Tensor, cam, cfg) -> Dict[str, float]:
    """K1's operations and bytes for rendering Gaussians ``gs`` [n, 14]
    on the whole sensor of ``cam`` under rasterizer config ``cfg``."""
    xyz, opacity, scales, quats, rgbs = unpack_points14(gs)
    n = gs.shape[0]
    prep = preprocess.preprocess(
        xyz, opacity, scales, quats, rgbs,
        torch.ones((n,), dtype=torch.bool, device=gs.device), cam,
        near_z=cfg.near_z)
    H, W = cam.img_h, cam.img_w
    bins = binning.bin_gaussians(prep, H, W, tile_h=cfg.tile_h,
                                 tile_w=cfg.tile_w,
                                 tile_capacity=cfg.tile_capacity,
                                 gate16=cfg.ref_tile16_gate)
    _, n_tx = binning.tile_grid(H, W, cfg.tile_h, cfg.tile_w)
    consts = blend.BlendConsts(
        tile_h=cfg.tile_h, tile_w=cfg.tile_w, n_tx=n_tx,
        alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max,
        t_eps=cfg.transmittance_eps, ref_gate=cfg.ref_tile16_gate)
    attrs = prep.attrs10()
    idx, counts = bins.gauss_index, bins.counts
    bg = torch.zeros((3,), dtype=torch.float32, device=gs.device)
    n_eval = blend.blend_forward_plain(attrs, idx, counts, (0.0, 0.0), bg,
                                       H, W, consts)[3]
    work = blend.blend_work(attrs, idx, counts, n_eval, (0.0, 0.0), consts)
    T, K = idx.shape
    kmask = torch.arange(K, device=idx.device)[None, :] < counts[:, None]
    n_gauss = int(torch.unique(idx[kmask]).numel())
    n_bytes = (n_gauss * attrs.shape[1] * 4 + int(counts.sum()) * 4 + T * 4
               + H * W * (3 + 1 + 1) * 4)
    ops = (work.pairs * FLOP_PER_GATED + work.eligible * FLOP_PER_ELIGIBLE
           + work.sub_tile_tests * CULL_OPS)
    return {"ops": float(ops), "bytes": float(n_bytes)}
