# -*- coding: utf-8 -*-
"""Per-pixel reference renderer, the correctness oracle (counterpart of
``gaussiancity_tpu/ops/rasterizer/naive.py``).

The tile renderer's sequential per-pixel semantics (upstream
forward.cu:238-346) without tiling: the Gaussians are stably sorted by
depth once for the whole image (a tile's (depth, index) order is that
order restricted to the tile), and every pixel blends front to back with
the same eligibility, alpha clamp and early termination.  A Gaussian
touches only pixels whose gate block (16x16 with the reference gate, else
the compute tile) lies inside its screen rect, since that too is
observable behaviour of the tiled renderer.

A plain PyTorch loop over the depth-sorted Gaussians, on [H, W] planes,
differentiable by autograd: its gradient is the oracle for the blend's
custom backward.  O(N * pixels); small scenes only.
"""

from __future__ import annotations

from typing import Optional

import torch

from gaussiancity_tpu_torch.camera import CameraParams
from gaussiancity_tpu_torch.config import RasterizerConfig
from gaussiancity_tpu_torch.ops.rasterizer import binning, preprocess


def naive_render(means3d: torch.Tensor, opacities: torch.Tensor,
                 scales: torch.Tensor, quats: torch.Tensor,
                 colors: torch.Tensor, cam: CameraParams,
                 cfg: RasterizerConfig = RasterizerConfig(),
                 valid: Optional[torch.Tensor] = None,
                 bg: Optional[torch.Tensor] = None,
                 scale_modifier: float = 1.0):
    """-> (image [3, H, W], final_T [H, W]), as ``rasterize`` renders the
    full sensor (no window, no tile capacity: every Gaussian counts)."""
    N = means3d.shape[0]
    dev = means3d.device
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=dev)
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    prep = preprocess.preprocess(means3d, opacities, scales, quats, colors,
                                 valid, cam, scale_modifier=scale_modifier,
                                 near_z=cfg.near_z)
    gate_h = 16 if cfg.ref_tile16_gate else cfg.tile_h
    gate_w = 16 if cfg.ref_tile16_gate else cfg.tile_w
    H, W = cam.img_h, cam.img_w
    x_min, y_min, x_max, y_max, _, pvalid = binning.compute_rects_c(
        prep.mx.detach(), prep.my.detach(), prep.radius, prep.valid, H, W,
        gate_h, gate_w)
    depth_key = torch.where(pvalid, prep.depth.detach(),
                            torch.full_like(prep.depth, float("inf")))
    order = torch.argsort(depth_key, stable=True)
    ix = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    iy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    tile_x = (torch.arange(W, device=dev) // gate_w)[None, :]
    tile_y = (torch.arange(H, device=dev) // gate_h)[:, None]
    T = torch.ones((H, W), dtype=torch.float32, device=dev)
    C = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    colors3 = torch.stack([prep.color_r, prep.color_g, prep.color_b], -1)
    # invalid Gaussians sort last and touch no pixel: stop at them
    for g in order[:int(pvalid.sum())].tolist():
        in_rect = ((tile_x >= x_min[g]) & (tile_x < x_max[g])
                   & (tile_y >= y_min[g]) & (tile_y < y_max[g]))
        dx = prep.mx[g] - ix
        dy = prep.my[g] - iy
        power = (-0.5 * (prep.conic_a[g] * dx * dx
                         + prep.conic_c[g] * dy * dy)
                 - prep.conic_b[g] * dx * dy)
        alpha = torch.clamp(prep.opacity[g] * torch.exp(power),
                            max=cfg.alpha_max)
        eligible = in_rect & (power <= 0.0) & (alpha >= cfg.alpha_min)
        test_T = T * (1.0 - alpha)
        live = eligible & ~done
        blend_m = live & (test_T >= cfg.transmittance_eps)
        w = torch.where(blend_m, alpha * T, torch.zeros_like(T))
        C = C + w[..., None] * colors3[g]
        T = torch.where(blend_m, test_T, T)
        done = done | (live & (test_T < cfg.transmittance_eps))
    image = (C + T[..., None] * bg).permute(2, 0, 1)
    return image, T
