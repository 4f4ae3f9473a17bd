# -*- coding: utf-8 -*-
"""Per-Gaussian preprocessing: projection, EWA 2D covariance, conic and
pixel radius (counterpart of ``gaussiancity_tpu/ops/rasterizer/
preprocess.py``; upstream preprocessCUDA, forward.cu:68-233).

Elementwise tensor code over [N] component vectors, written in the same
operation order as the JAX version so that both round alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gcbench.reference.gct.camera import CameraParams


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space state (component vectors, all [N])."""

    mx: torch.Tensor
    my: torch.Tensor
    conic_a: torch.Tensor
    conic_b: torch.Tensor
    conic_c: torch.Tensor
    opacity: torch.Tensor
    color_r: torch.Tensor
    color_g: torch.Tensor
    color_b: torch.Tensor
    depth: torch.Tensor
    radius: torch.Tensor  # int32 pixel radius (0 => culled)
    valid: torch.Tensor  # bool, survives culling

    def attrs10(self) -> torch.Tensor:
        """[N, 10] float32 rows: mx, my, ca, cb, cc, op, r, g, b, radius
        (the first ten rows of the JAX package's ``attrs16``), the blend
        kernel's input layout."""
        return torch.stack(
            [self.mx, self.my, self.conic_a, self.conic_b, self.conic_c,
             self.opacity, self.color_r, self.color_g, self.color_b,
             self.radius.to(self.mx.dtype)], dim=-1).float().contiguous()


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor,
                  scale_modifier: float = 1.0):
    """World-space covariance R S S^T R^T as six [N] components
    (xx, xy, xz, yy, yz, zz); quaternions are wxyz and not normalized."""
    r, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    sx = scales[..., 0] * scale_modifier
    sy = scales[..., 1] * scale_modifier
    sz = scales[..., 2] * scale_modifier
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - r * z)
    r02 = 2.0 * (x * z + r * y)
    r10 = 2.0 * (x * y + r * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - r * x)
    r20 = 2.0 * (x * z - r * y)
    r21 = 2.0 * (y * z + r * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    c_xx = m00 * m00 + m01 * m01 + m02 * m02
    c_xy = m00 * m10 + m01 * m11 + m02 * m12
    c_xz = m00 * m20 + m01 * m21 + m02 * m22
    c_yy = m10 * m10 + m11 * m11 + m12 * m12
    c_yz = m10 * m20 + m11 * m21 + m12 * m22
    c_zz = m20 * m20 + m21 * m21 + m22 * m22
    return c_xx, c_xy, c_xz, c_yy, c_yz, c_zz


def ndc_to_pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def preprocess(means3d: torch.Tensor, opacities: torch.Tensor,
               scales: torch.Tensor, quats: torch.Tensor,
               colors: torch.Tensor, valid_in: torch.Tensor,
               cam: CameraParams, scale_modifier: float = 1.0,
               near_z: float = 0.2) -> Preprocessed:
    """Preprocess N Gaussians (upstream forward.cu:147-233)."""
    px, py, pz = means3d[..., 0], means3d[..., 1], means3d[..., 2]

    FP = cam.full_proj
    hx = FP[0, 0] * px + FP[0, 1] * py + FP[0, 2] * pz + FP[0, 3]
    hy = FP[1, 0] * px + FP[1, 1] * py + FP[1, 2] * pz + FP[1, 3]
    hw = FP[3, 0] * px + FP[3, 1] * py + FP[3, 2] * pz + FP[3, 3]
    p_w = 1.0 / (hw + 1e-7)

    V = cam.view_matrix
    tx = V[0, 0] * px + V[0, 1] * py + V[0, 2] * pz + V[0, 3]
    ty = V[1, 0] * px + V[1, 1] * py + V[1, 2] * pz + V[1, 3]
    tz = V[2, 0] * px + V[2, 1] * py + V[2, 2] * pz + V[2, 3]

    c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = compute_cov3d(
        scales, quats, scale_modifier)

    # EWA 2D covariance (upstream forward.cu:68-105)
    limx = 1.3 * cam.tan_fovx
    limy = 1.3 * cam.tan_fovy
    txc = torch.clamp(tx / tz, -limx, limx) * tz
    tyc = torch.clamp(ty / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    J00 = cam.focal_x * inv_z
    J02 = -cam.focal_x * txc * inv_z2
    J11 = cam.focal_y * inv_z
    J12 = -cam.focal_y * tyc * inv_z2
    W00, W01, W02 = V[0, 0], V[0, 1], V[0, 2]
    W10, W11, W12 = V[1, 0], V[1, 1], V[1, 2]
    W20, W21, W22 = V[2, 0], V[2, 1], V[2, 2]
    a0 = J00 * W00 + J02 * W20
    a1 = J00 * W01 + J02 * W21
    a2 = J00 * W02 + J02 * W22
    b0 = J11 * W10 + J12 * W20
    b1 = J11 * W11 + J12 * W21
    b2 = J11 * W12 + J12 * W22
    Sa0 = c_xx * a0 + c_xy * a1 + c_xz * a2
    Sa1 = c_xy * a0 + c_yy * a1 + c_yz * a2
    Sa2 = c_xz * a0 + c_yz * a1 + c_zz * a2
    cov_xx = a0 * Sa0 + a1 * Sa1 + a2 * Sa2 + 0.3
    cov_xy = b0 * Sa0 + b1 * Sa1 + b2 * Sa2
    Sb0 = c_xx * b0 + c_xy * b1 + c_xz * b2
    Sb1 = c_xy * b0 + c_yy * b1 + c_yz * b2
    Sb2 = c_xz * b0 + c_yz * b1 + c_zz * b2
    cov_yy = b0 * Sb0 + b1 * Sb1 + b2 * Sb2 + 0.3

    det = cov_xx * cov_yy - cov_xy * cov_xy
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conic_a = cov_yy * inv_det
    conic_b = -cov_xy * inv_det
    conic_c = cov_xx * inv_det

    mid = 0.5 * (cov_xx + cov_yy)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam_max, min=0.0)))
    radius = radius.detach().to(torch.int32)

    mx = ndc_to_pix(hx * p_w, cam.img_w)
    my = ndc_to_pix(hy * p_w, cam.img_h)

    valid = valid_in & (tz > near_z) & (det != 0.0) & (radius > 0)
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    return Preprocessed(
        mx=mx, my=my, conic_a=conic_a, conic_b=conic_b, conic_c=conic_c,
        opacity=opacities, color_r=colors[..., 0], color_g=colors[..., 1],
        color_b=colors[..., 2], depth=tz, radius=radius, valid=valid)
