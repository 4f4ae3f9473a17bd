# -*- coding: utf-8 -*-
"""Palettes, point helpers on tensors and host-side logging helpers
(counterpart of ``gaussiancity_tpu/utils/helpers.py``; upstream
utils/helpers.py), plus the instance -> class map whose JAX counterpart
lives in ``gaussiancity_tpu/training/step.py``."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

MAX_N_INSTANCES = 16384


# ---------------------------------------------------------------------------
# palettes and the instance-id colour code (upstream utils/helpers.py:44-124)
# ---------------------------------------------------------------------------


def get_seg_map_palette() -> np.ndarray:
    palette = np.array([[i, i, i] for i in range(256)])
    palette[:9] = np.array([
        [0, 0, 0],       # empty
        [96, 0, 0],      # road
        [96, 96, 0],     # freeway
        [0, 96, 0],      # car
        [0, 96, 96],     # water
        [0, 0, 96],      # sky
        [96, 96, 96],    # ground
        [96, 0, 96],     # building facade
        [255, 0, 255],   # building roof
    ])
    return palette


def get_ins_seg_map_palette(legacy_palette: np.ndarray, random: bool = True,
                            seed: Optional[int] = None) -> np.ndarray:
    if random:
        rng = np.random.default_rng(seed)
        palette = rng.integers(256, size=(MAX_N_INSTANCES, 3)).astype(
            np.uint8)
        palette[:9] = legacy_palette[:9]
    else:
        palette = np.array(
            [[i % 4 * 64, i * 4 % 256, (i * 4 // 256) % 256]
             for i in range(MAX_N_INSTANCES)], dtype=np.uint8)
    return palette


def get_ins_id(img: np.ndarray) -> np.ndarray:
    """RGB-encoded instance ids -> uint16 ids, 0 where the check channel
    disagrees (upstream utils/helpers.py:96-104)."""
    instances = (img[..., 1].astype(np.int64)
                 + img[..., 2].astype(np.int64) * 256)
    instances = np.round(instances / 4).astype(np.uint16)
    error_idx = np.round(img[..., 0] / 64).astype(np.uint8) != instances % 4
    instances[error_idx] = 0
    return instances


def get_ins_colors(obj: np.ndarray, random: bool = True,
                   seed: Optional[int] = 0) -> np.ndarray:
    pal = get_ins_seg_map_palette(get_seg_map_palette(), random=random,
                                  seed=seed)
    return pal[np.asarray(obj) % MAX_N_INSTANCES].astype(np.uint8)


# ---------------------------------------------------------------------------
# points on the device
# ---------------------------------------------------------------------------


def get_one_hot(classes: torch.Tensor, n_class: int) -> torch.Tensor:
    """classes [B, N] or [B, N, 1] int -> [B, N, n_class] float32."""
    if classes.dim() == 3:
        classes = classes[..., 0]
    return F.one_hot(classes.long(), n_class).float()


def get_z(generator: Optional[torch.Generator], instances: torch.Tensor,
          z_dim: Optional[int], max_instances: int = MAX_N_INSTANCES
          ) -> Optional[torch.Tensor]:
    """Per-point style codes: one N(0, 1) row per instance-id slot (id mod
    ``max_instances``) of a table drawn from ``generator`` on its own
    device, which must be the points' device, gathered to the points.
    instances [B, N] -> [B, N, z_dim], or None without ``z_dim``.  The
    draws differ from ``jax.random``'s."""
    if z_dim is None:
        return None
    if generator is None:
        raise ValueError("get_z needs a torch.Generator: style codes are "
                         "never drawn from the global RNG")
    dev = instances.device
    if (generator.device.type != dev.type
            or generator.device.index not in (None, dev.index)):
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"instances on {dev}")
    table = torch.randn((max_instances, z_dim), generator=generator,
                        device=dev)
    return table[instances.long() % max_instances]


def get_camera_look_at(cam_position, cam_quaternion,
                       step: float = 1000.0) -> np.ndarray:
    """The point ``step`` units along the camera's forward axis
    (upstream utils/helpers.py:162-164)."""
    from gcbench.reference.gct.camera import quat_xyzw_to_matrix

    R = quat_xyzw_to_matrix(np.asarray(cam_quaternion, np.float64))
    return np.asarray(cam_position, np.float64) + R[:, 0] * step


def repeat_pts(pts: torch.Tensor, repeat: int = 1) -> torch.Tensor:
    """Tile the points ``repeat`` times along N with a repeat-index channel
    appended (upstream utils/helpers.py:175-180).  pts [B, N, C] ->
    [B, N * repeat, C + 1]; the index cycles 0, 1/r, ... along the tiled
    axis, as upstream tiles its [repeat] pattern n times."""
    b, n, _ = pts.shape
    idx = torch.arange(repeat, dtype=pts.dtype, device=pts.device) / repeat
    idx = idx.repeat(n)[None, :, None].expand(b, n * repeat, 1)
    return torch.cat([pts.repeat(1, repeat, 1), idx], dim=-1)


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


def onehot_to_mask(onehot: torch.Tensor,
                   ignored_classes: Sequence[int] = ()) -> torch.Tensor:
    """argmax over the channel dim (NHWC), shifting ids past the ignored
    classes (upstream utils/helpers.py:167-172)."""
    mask = torch.argmax(onehot, dim=-1)
    for ic in ignored_classes:
        mask = torch.where(mask >= ic, mask + 1, mask)
    return mask


# ---------------------------------------------------------------------------
# host-side logging helpers
# ---------------------------------------------------------------------------


def tensor_to_image(t, mode: str) -> np.ndarray:
    """An image for the logs (upstream utils/helpers.py:314-324): "RGB"
    takes [-1, 1] values, NHWC-style HWC or CHW, and returns HWC in
    [0, 1]; "Mask" squeezes."""
    arr = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
           else np.asarray(t))
    if mode == "RGB":
        if arr.ndim == 3 and arr.shape[0] == 3:
            arr = arr.transpose(1, 2, 0)
        return arr / 2.0 + 0.5
    if mode == "Mask":
        return arr.squeeze()
    raise ValueError(f"Unknown mode: {mode}")


def dump_ptcloud_ply(path: str, xyz: np.ndarray, rgb: np.ndarray,
                     attrs: Optional[Dict[str, np.ndarray]] = None) -> None:
    """An ASCII PLY of coloured points with optional float attributes,
    x and y shifted by the (int16) centre of their range (upstream
    utils/helpers.py:273-311, without the plyfile dependency)."""
    attrs = attrs or {}
    xyz = np.asarray(xyz, np.float32).copy()
    rgb = np.asarray(rgb)
    xyz[:, 0] -= np.int16((xyz[:, 0].min() + xyz[:, 0].max()) / 2)
    xyz[:, 1] -= np.int16((xyz[:, 1].min() + xyz[:, 1].max()) / 2)
    keys = sorted(attrs)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        for k in keys:
            f.write(f"property float {k}\n")
        f.write("end_header\n")
        for i in range(len(xyz)):
            row = [f"{xyz[i, 0]:.4f}", f"{xyz[i, 1]:.4f}",
                   f"{xyz[i, 2]:.4f}", str(int(rgb[i, 0])),
                   str(int(rgb[i, 1])), str(int(rgb[i, 2]))]
            row += [f"{float(attrs[k][i]):.6f}" for k in keys]
            f.write(" ".join(row) + "\n")
