# -*- coding: utf-8 -*-
"""Spherical-harmonics colour evaluation (counterpart of
``gaussiancity_tpu/ops/rasterizer/sh.py``; upstream computeColorFromSH,
forward.cu:20-66).  SH coefficients are [N, M, 3] with M >= (deg+1)^2."""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def num_sh_coeffs(deg: int) -> int:
    return (deg + 1) ** 2


def eval_sh_colors(shs: torch.Tensor, means3d: torch.Tensor,
                   campos: torch.Tensor, deg: int) -> torch.Tensor:
    """Per-Gaussian RGB [N, 3] along the normalized view direction,
    clamped to >= 0."""
    if not 0 <= deg <= 3:
        raise ValueError(f"sh degree must be in [0, 3], got {deg}")
    if shs.shape[1] < num_sh_coeffs(deg):
        raise ValueError(
            f"shs has {shs.shape[1]} coefficients; degree {deg} needs "
            f"{num_sh_coeffs(deg)}")
    d = means3d - campos[None, :]
    inv_len = 1.0 / torch.clamp(torch.linalg.norm(d, dim=-1), min=1e-12)
    x = (d[:, 0] * inv_len)[:, None]
    y = (d[:, 1] * inv_len)[:, None]
    z = (d[:, 2] * inv_len)[:, None]

    result = SH_C0 * shs[:, 0]
    if deg > 0:
        result = (result - SH_C1 * y * shs[:, 1] + SH_C1 * z * shs[:, 2]
                  - SH_C1 * x * shs[:, 3])
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (result
                  + (SH_C2[0] * xy) * shs[:, 4]
                  + (SH_C2[1] * yz) * shs[:, 5]
                  + (SH_C2[2] * (2.0 * zz - xx - yy)) * shs[:, 6]
                  + (SH_C2[3] * xz) * shs[:, 7]
                  + (SH_C2[4] * (xx - yy)) * shs[:, 8])
    if deg > 2:
        result = (result
                  + (SH_C3[0] * y * (3.0 * xx - yy)) * shs[:, 9]
                  + (SH_C3[1] * xy * z) * shs[:, 10]
                  + (SH_C3[2] * y * (4.0 * zz - xx - yy)) * shs[:, 11]
                  + (SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy))
                  * shs[:, 12]
                  + (SH_C3[4] * x * (4.0 * zz - xx - yy)) * shs[:, 13]
                  + (SH_C3[5] * z * (xx - yy)) * shs[:, 14]
                  + (SH_C3[6] * x * (xx - 3.0 * yy)) * shs[:, 15])
    pre = result + 0.5
    return torch.where(pre < 0.0, torch.zeros_like(pre), pre)
