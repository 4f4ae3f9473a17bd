# -*- coding: utf-8 -*-
"""Tile-local front-to-back alpha blending, forward (counterpart of the
forward of ``gaussiancity_tpu/ops/rasterizer/blend.py::blend_gathered``).

``blend_forward`` launches kernel K1 (``csrc/blend_fwd.cu``) on CUDA
tensors and runs ``blend_forward_plain`` on CPU tensors.  Both implement
the sequential per-pixel semantics of upstream renderCUDA
(forward.cu:238-346) and of the JAX package's ``_blend_fwd_impl``:

- a slot is eligible iff ``k < count``, ``power <= 0`` and
  ``alpha >= alpha_min``; with ``ref_gate`` the pixel's 16x16 sensor block
  must also lie in the slot's getRect bbox;
- an eligible slot blends iff the pixel is not done and
  ``T * (1 - alpha) >= t_eps``, and otherwise marks the pixel done;
- window renders shift the pixel origin, never the means.

Gradients belong to the training slice: there is no backward yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gaussiancity_tpu_torch import _kernels

ATTR_COLS = 10  # mx, my, ca, cb, cc, op, r, g, b, radius (attrs10)


class BlendConsts(NamedTuple):
    tile_h: int
    tile_w: int
    n_tx: int
    alpha_min: float = 1.0 / 255.0
    alpha_max: float = 0.99
    t_eps: float = 1e-4
    ref_gate: bool = False


def _pixel_planes(consts: BlendConsts, T: int, origin, device):
    """Sensor pixel coordinates [T, 1, TW] / [T, TH, 1] of every tile."""
    tid = torch.arange(T, device=device)
    x0 = ((tid % consts.n_tx) * consts.tile_w).float() + float(origin[0])
    y0 = ((tid // consts.n_tx) * consts.tile_h).float() + float(origin[1])
    ix = torch.arange(consts.tile_w, device=device, dtype=torch.float32)
    iy = torch.arange(consts.tile_h, device=device, dtype=torch.float32)
    return x0[:, None, None] + ix[None, None, :], \
        y0[:, None, None] + iy[None, :, None]


def _assemble(tiles: torch.Tensor, consts: BlendConsts, img_h: int,
              img_w: int) -> torch.Tensor:
    """[T, TH, TW] -> [H, W] (crop off tile padding)."""
    T, TH, TW = tiles.shape
    n_ty = T // consts.n_tx
    img = tiles.reshape(n_ty, consts.n_tx, TH, TW).permute(0, 2, 1, 3)
    return img.reshape(n_ty * TH, consts.n_tx * TW)[:img_h, :img_w]


def blend_forward_plain(attrs: torch.Tensor, gauss_index: torch.Tensor,
                        counts: torch.Tensor, origin: Tuple[float, float],
                        bg: torch.Tensor, img_h: int, img_w: int,
                        consts: BlendConsts):
    """Plain PyTorch version of K1, one slot per step over all tiles.

    Returns (image [3, H, W] with background, final_T [H, W],
    n_contrib [H, W] int32, n_evaluated [H, W] int32), where
    ``n_evaluated`` counts the slots each pixel tested before it saturated
    or its tile ran out: the work the front-to-back loop needs."""
    T, K = gauss_index.shape
    dev = attrs.device
    px, py = _pixel_planes(consts, T, origin, dev)
    shape = (T, consts.tile_h, consts.tile_w)
    if consts.ref_gate:
        bx16 = torch.floor(px * 0.0625)
        by16 = torch.floor(py * 0.0625)
    T_acc = torch.ones(shape, dtype=torch.float32, device=dev)
    C = [torch.zeros(shape, dtype=torch.float32, device=dev)
         for _ in range(3)]
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    nc = torch.zeros(shape, dtype=torch.int32, device=dev)
    n_eval = torch.zeros(shape, dtype=torch.int32, device=dev)
    counts = counts.to(dev)
    k_end = int(counts.max()) if T else 0
    for k in range(k_end):
        a = attrs[gauss_index[:, k].long()]  # [T, 10]
        col = [a[:, c, None, None] for c in range(ATTR_COLS)]
        mx, my, ca, cb, cc, op = col[:6]
        active = (k < counts)[:, None, None]
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=consts.alpha_max)
        eligible = active & (power <= 0.0) & (alpha >= consts.alpha_min)
        if consts.ref_gate:
            rd = col[9]
            xlo = torch.floor((mx - rd) * 0.0625)
            xhi = torch.floor((mx + rd + 15.0) * 0.0625)
            ylo = torch.floor((my - rd) * 0.0625)
            yhi = torch.floor((my + rd + 15.0) * 0.0625)
            eligible = eligible & ((bx16 >= xlo) & (bx16 < xhi)
                                   & (by16 >= ylo) & (by16 < yhi))
        n_eval += (active & ~done).to(torch.int32)
        test_T = T_acc * (1.0 - alpha)
        live = eligible & ~done
        blend = live & (test_T >= consts.t_eps)
        done = done | (live & (test_T < consts.t_eps))
        w = torch.where(blend, alpha * T_acc, torch.zeros_like(alpha))
        for c in range(3):
            C[c] = C[c] + w * col[6 + c]
        T_acc = torch.where(blend, test_T, T_acc)
        nc = torch.where(blend, torch.full_like(nc, k + 1), nc)
    final_T = _assemble(T_acc, consts, img_h, img_w)
    bg = bg.to(dev, torch.float32)
    image = torch.stack([_assemble(C[c], consts, img_h, img_w)
                         + final_T * bg[c] for c in range(3)])
    return (image, final_T, _assemble(nc, consts, img_h, img_w),
            _assemble(n_eval, consts, img_h, img_w))


def _check_inputs(attrs, gauss_index, counts, bg, consts, img_h, img_w):
    dev = attrs.device
    for name, t, dtype in (("attrs", attrs, torch.float32),
                           ("gauss_index", gauss_index, torch.int32),
                           ("counts", counts, torch.int32),
                           ("bg", bg, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, attrs on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    T = gauss_index.shape[0]
    n_ty = -(-img_h // consts.tile_h)
    if attrs.dim() != 2 or attrs.shape[1] != ATTR_COLS:
        raise ValueError(f"attrs must be [N, {ATTR_COLS}], got "
                         f"{tuple(attrs.shape)}")
    if gauss_index.dim() != 2 or tuple(counts.shape) != (T,):
        raise ValueError("gauss_index must be [T, K] and counts [T]")
    if T != n_ty * consts.n_tx or consts.n_tx * consts.tile_w < img_w:
        raise ValueError(f"{T} tiles do not cover a {img_h}x{img_w} image")
    if bg.shape != (3,):
        raise ValueError("bg must be [3]")
    if not 0 < consts.tile_h * consts.tile_w <= 1024:
        raise ValueError("a tile must hold 1..1024 pixels (one thread "
                         "each)")


def blend_forward(attrs: torch.Tensor, gauss_index: torch.Tensor,
                  counts: torch.Tensor, origin: Tuple[float, float],
                  bg: torch.Tensor, img_h: int, img_w: int,
                  consts: BlendConsts):
    """Blend the binned Gaussians of every tile, front to back.

    ``attrs`` [N, 10] float32 (``Preprocessed.attrs10``), ``gauss_index``
    [T, K] int32 and ``counts`` [T] int32 from binning, ``origin`` the
    sensor position of pixel (0, 0), ``bg`` [3].  Returns (image [3, H, W]
    with background, final_T [H, W], n_contrib [H, W] int32).

    CUDA tensors go to kernel K1; CPU tensors to the plain version."""
    _check_inputs(attrs, gauss_index, counts, bg, consts, img_h, img_w)
    if not attrs.is_cuda:
        return blend_forward_plain(attrs, gauss_index, counts, origin, bg,
                                   img_h, img_w, consts)[:3]
    T, K = gauss_index.shape
    dev = attrs.device
    image = torch.empty((3, img_h, img_w), dtype=torch.float32, device=dev)
    final_T = torch.empty((img_h, img_w), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((img_h, img_w), dtype=torch.int32, device=dev)
    if T:
        _kernels.launch(
            "blend_fwd", attrs.data_ptr(), gauss_index.data_ptr(),
            counts.data_ptr(), bg.data_ptr(), T, K, consts.n_tx,
            consts.tile_h, consts.tile_w, img_h, img_w, float(origin[0]),
            float(origin[1]), int(consts.ref_gate), consts.alpha_min,
            consts.alpha_max, consts.t_eps, image.data_ptr(),
            final_T.data_ptr(), n_contrib.data_ptr(),
            _kernels.stream_handle(dev))
        blend_forward.launches += 1
    return image, final_T, n_contrib


blend_forward.launches = 0
