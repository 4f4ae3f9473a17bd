# -*- coding: utf-8 -*-
"""Point helpers on tensors (counterpart of
``gaussiancity_tpu/utils/helpers.py``), plus the instance -> class map
whose JAX counterpart lives in ``gaussiancity_tpu/training/step.py``."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

MAX_N_INSTANCES = 16384


def get_one_hot(classes: torch.Tensor, n_class: int) -> torch.Tensor:
    """classes [B, N] or [B, N, 1] int -> [B, N, n_class] float32."""
    if classes.dim() == 3:
        classes = classes[..., 0]
    return F.one_hot(classes.long(), n_class).float()


def get_projection_uv(xyz: torch.Tensor, proj_tlp: Optional[torch.Tensor],
                      proj_size: float) -> torch.Tensor:
    """[-1, 1] uv of each point on the projection map. xyz: [B, N, 3]."""
    uv = xyz[..., :2] if proj_tlp is None else (
        xyz[..., :2] - proj_tlp[:, None, :])
    uv = uv / proj_size
    return uv * 2.0 - 1.0


def get_point_scales(scales: torch.Tensor, classes: torch.Tensor,
                     special_z_scale_classes: Sequence[int] = ()
                     ) -> torch.Tensor:
    """[..., 1] isotropic scale -> [..., 3], z-scale forced to 1 for the
    road / water / zone classes."""
    if classes.dim() == scales.dim():
        classes = classes[..., 0]
    scales_3d = scales.repeat_interleave(3, dim=-1)
    if len(special_z_scale_classes):
        special = torch.isin(
            classes.long(),
            torch.as_tensor(list(special_z_scale_classes),
                            device=classes.device))
        z = torch.where(special, torch.ones_like(scales_3d[..., 2]),
                        scales_3d[..., 2])
        scales_3d = torch.cat([scales_3d[..., :2], z[..., None]], dim=-1)
    return scales_3d


def get_gaussian_points(xyz: torch.Tensor, scales: torch.Tensor,
                        attrs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Pack the 14-channel Gaussian layout (xyz, opacity, scale3, quat4,
    rgb3) with identity rotation and opacity 1 unless predicted.
    xyz [B, N, 3], scales [B, N, 3] -> [B, N, 14]."""
    B, N = xyz.shape[:2]
    rgb = attrs["rgb"]
    if "xyz" in attrs:
        xyz = xyz + attrs["xyz"]
    if "scale" in attrs:
        scales = scales * attrs["scale"]
    opacity = attrs.get("opacity", xyz.new_ones((B, N, 1)))
    rotations = torch.cat([xyz.new_ones((B, N, 1)), xyz.new_zeros((B, N, 3))],
                          dim=-1)
    return torch.cat([xyz, opacity, scales, rotations, rgb], dim=-1)


def instances_to_classes(instances: torch.Tensor, bldg_range, facade_clsid,
                         roof_clsid, car_range=None, car_clsid=None
                         ) -> torch.Tensor:
    """Instance id -> class id: building ids map even -> facade and odd ->
    roof; an optional car range maps to the car class."""
    inst = instances.long()
    in_bldg = (inst >= bldg_range[0]) & (inst < bldg_range[1])
    classes = torch.where(in_bldg & (inst % 2 == 0),
                          torch.full_like(inst, facade_clsid), inst)
    classes = torch.where(in_bldg & (inst % 2 == 1),
                          torch.full_like(inst, roof_clsid), classes)
    if car_range is not None:
        in_car = (inst >= car_range[0]) & (inst < car_range[1])
        classes = torch.where(in_car, torch.full_like(inst, car_clsid),
                              classes)
    return classes
