# -*- coding: utf-8 -*-
"""Gaussian rasterization, public API (counterpart of
``gaussiancity_tpu/ops/rasterizer/api.py``; upstream GaussianRasterizer /
GaussianRasterizerWrapper, diff_gaussian_rasterization/__init__.py).

``rasterize`` runs preprocess -> binning -> blend (kernel K1 on CUDA) and
returns the image, the final transmittance and the three exactness
counters.  It is differentiable with respect to means3d, opacities,
scales, quats, colors (or shs) and bg: the blend's backward is kernel K2
plus the per-Gaussian reduction through kernel K3 (``_BlendFunction``),
and autograd carries the per-Gaussian rows through ``preprocess``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from gaussiancity_tpu_torch.camera import CameraModel, CameraParams
from gaussiancity_tpu_torch.config import RasterizerConfig
from gaussiancity_tpu_torch.ops.rasterizer import binning, blend, preprocess
from gaussiancity_tpu_torch.utils import profiling


class RenderOutput(NamedTuple):
    image: torch.Tensor  # [3, H, W]
    final_T: torch.Tensor  # [H, W]
    radii: torch.Tensor  # [N] int32
    n_dropped_pairs: torch.Tensor  # scalar int32 (0: binning is uncapped)
    n_truncated: torch.Tensor  # scalar int32: slots beyond tile_capacity
    # scalar int32: slots carrying gradient past grad_capacity /
    # grad_budget (0: the backward is exact)
    n_grad_truncated: torch.Tensor


class _BlendFunction(torch.autograd.Function):
    """Forward through ``blend.blend_forward`` (K1); backward through
    ``blend.blend_backward`` (K2) and ``blend.reduce_slot_grads`` (K3),
    the port's ``blend_gathered`` custom VJP.  Returns (image, final_T,
    n_contrib, n_grad_truncated); the last two carry no gradient."""

    @staticmethod
    def forward(ctx, attrs, bg, gauss_index, counts, origin, img_h, img_w,
                consts, grad_cfg):
        image, final_T, n_contrib = blend.blend_forward(
            attrs, gauss_index, counts, origin, bg, img_h, img_w, consts)
        grad_capacity, grad_budget, page = grad_cfg
        k_hi = blend.tile_k_hi(counts, n_contrib, consts)
        n_trunc = blend.grad_trunc_count(k_hi, grad_capacity, grad_budget,
                                         gauss_index.shape[1], page)
        ctx.mark_non_differentiable(n_contrib, n_trunc)
        ctx.save_for_backward(attrs, bg, gauss_index, k_hi, final_T,
                              n_contrib)
        ctx.origin, ctx.consts, ctx.grad_cfg = origin, consts, grad_cfg
        return image, final_T, n_contrib, n_trunc

    @staticmethod
    @once_differentiable
    def backward(ctx, g_image, g_T, _g_nc, _g_trunc):
        attrs, bg, gauss_index, k_hi, final_T, n_contrib = ctx.saved_tensors
        if g_image is None:
            g_image = torch.zeros((3, *final_T.shape), dtype=torch.float32,
                                  device=final_T.device)
        g_image = g_image.float().contiguous()
        d_bg = (final_T[None] * g_image).sum(dim=(1, 2))
        # out = C + final_T * bg couples every alpha to bg, and final_T is
        # an output of its own
        bg_dot_g = bg[0] * g_image[0] + bg[1] * g_image[1] + bg[2] * g_image[2]
        if g_T is not None:
            bg_dot_g = bg_dot_g + g_T
        with profiling.span("raster.blend"):
            grads = blend.blend_backward(
                attrs, gauss_index, k_hi, ctx.origin, g_image,
                bg_dot_g.contiguous(), final_T, n_contrib, ctx.consts)
            rows = blend.reduce_slot_grads(grads, gauss_index, k_hi,
                                           attrs.shape[0], *ctx.grad_cfg)
        d_attrs = torch.cat([rows, rows.new_zeros((rows.shape[0], 1))], 1)
        return (d_attrs, d_bg) + (None,) * 7


def rasterize(means3d: torch.Tensor, opacities: torch.Tensor,
              scales: torch.Tensor, quats: torch.Tensor,
              colors: Optional[torch.Tensor], cam: CameraParams,
              cfg: RasterizerConfig = RasterizerConfig(),
              valid: Optional[torch.Tensor] = None,
              bg: Optional[torch.Tensor] = None,
              scale_modifier: float = 1.0,
              shs: Optional[torch.Tensor] = None, sh_degree: int = 0,
              window: Optional[Tuple] = None) -> RenderOutput:
    """Render N Gaussians to a [3, H, W] image.

    Exactly one of ``colors`` ([N, 3]) and ``shs`` ([N, M, 3], evaluated
    along the view direction at ``sh_degree``) must be given.
    ``window=(x0, y0, Wc, Hc)`` renders only that sensor window: the
    preprocess stays on the full-sensor camera, binning sees
    window-local means, and the blend shifts its pixel origin, so every
    window pixel equals the same pixel of the full render."""
    N = means3d.shape[0]
    dev = means3d.device
    if (colors is None) == (shs is None):
        raise ValueError("exactly one of colors and shs must be provided")
    with profiling.span("raster.preprocess"):
        if colors is None:
            from gaussiancity_tpu_torch.ops.rasterizer import sh as _sh

            colors = _sh.eval_sh_colors(shs, means3d, cam.cam_pos, sh_degree)
        if valid is None:
            valid = torch.ones((N,), dtype=torch.bool, device=dev)
        if bg is None:
            bg = torch.zeros((3,), dtype=torch.float32, device=dev)
        prep = preprocess.preprocess(
            means3d, opacities, scales, quats, colors, valid, cam,
            scale_modifier=scale_modifier, near_z=cfg.near_z)
    return rasterize_preprocessed(prep, bg, cam.img_h, cam.img_w, cfg,
                                  window)


def rasterize_preprocessed(prep: preprocess.Preprocessed, bg: torch.Tensor,
                           img_h: int, img_w: int,
                           cfg: RasterizerConfig = RasterizerConfig(),
                           window: Optional[Tuple] = None) -> RenderOutput:
    """Binning and blend of Gaussians already in screen space (``rasterize``
    after ``preprocess``) on an ``img_h`` x ``img_w`` sensor, or on its
    ``window``.  A window may reach past the sensor's last row: those
    pixels are rendered like any other and are the caller's to crop (the
    band-sharded rasterizer's padded last band)."""
    origin = (0.0, 0.0)
    bin_prep = prep
    if window is not None:
        x0, y0, wc, hc = window
        origin = (float(x0), float(y0))
        bin_prep = prep._replace(mx=prep.mx - origin[0],
                                 my=prep.my - origin[1])
        img_w, img_h = int(wc), int(hc)
    with profiling.span("raster.binning"):
        bins = binning.bin_gaussians(
            bin_prep, img_h, img_w, tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            tile_capacity=cfg.tile_capacity, gate16=cfg.ref_tile16_gate,
            gate_origin=origin if window is not None else None)
    _, n_tx = binning.tile_grid(img_h, img_w, cfg.tile_h, cfg.tile_w)
    consts = blend.BlendConsts(
        tile_h=cfg.tile_h, tile_w=cfg.tile_w, n_tx=n_tx,
        alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max,
        t_eps=cfg.transmittance_eps, ref_gate=cfg.ref_tile16_gate)
    grad_cfg = (cfg.grad_capacity, cfg.grad_budget,
                cfg.page or blend.DEFAULT_PAGE)
    with profiling.span("raster.blend"):
        image, final_T, _, n_grad_truncated = _BlendFunction.apply(
            prep.attrs10(), bg.float().contiguous(), bins.gauss_index,
            bins.counts, origin, img_h, img_w, consts, grad_cfg)
    return RenderOutput(
        image=image, final_T=final_T, radii=prep.radius,
        n_dropped_pairs=bins.n_dropped_pairs, n_truncated=bins.n_truncated,
        n_grad_truncated=n_grad_truncated)


def mark_visible(means3d: torch.Tensor, cam: CameraParams,
                 near_z: float = 0.2) -> torch.Tensor:
    """Frustum visibility per point: camera-space z > near_z."""
    V = cam.view_matrix
    return means3d @ V[2, :3] + V[2, 3] > near_z


def unpack_points14(points: torch.Tensor):
    """Split the packed 14-channel layout (xyz, opacity, scale3, quat4,
    rgb3)."""
    if points.shape[-1] != 14:
        raise ValueError("points must have 14 channels")
    return (points[..., 0:3], points[..., 3], points[..., 4:7],
            points[..., 7:11], points[..., 11:14])


def rasterize_points14(points: torch.Tensor, cam: CameraParams,
                       cfg: RasterizerConfig = RasterizerConfig(),
                       valid: Optional[torch.Tensor] = None,
                       bg: Optional[torch.Tensor] = None,
                       window: Optional[Tuple] = None) -> RenderOutput:
    xyz, opacity, scales, quats, rgbs = unpack_points14(points)
    return rasterize(xyz, opacity, scales, quats, rgbs, cam, cfg, valid, bg,
                     window=window)


class GaussianRasterizerWrapper:
    """Camera-owning wrapper: shared K and sensor size, per-call position
    and quaternion (xyzw), optional left-right / up-down flips."""

    def __init__(self, K, sensor_size: Tuple[int, int], flip_lr: bool = True,
                 flip_ud: bool = False, z_near: float = 0.01,
                 z_far: float = 50000.0,
                 cfg: RasterizerConfig = RasterizerConfig()):
        self.camera = CameraModel(K, sensor_size, z_near, z_far)
        self.flip_lr = flip_lr
        self.flip_ud = flip_ud
        self.cfg = cfg

    def __call__(self, points: torch.Tensor, cam_position, cam_quaternion,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        cam = self.camera.params(cam_position, cam_quaternion,
                                 device=points.device)
        img = rasterize_points14(points, cam, self.cfg, valid=valid).image
        if self.flip_lr:
            img = img.flip(-1)
        if self.flip_ud:
            img = img.flip(-2)
        return img
