# -*- coding: utf-8 -*-
"""Camera-pose recovery from raw captures (counterpart of
``gaussiancity_tpu/data/camera_recovery.py``).

Converts the published raw capture formats into the ``CameraPoses.csv`` +
camera-rig intrinsics this framework's datasets consume:

- **Google Earth Studio**: a ``<project>.json`` with per-frame lng/lat/alt
  and the vertical FoV (reference: scripts/dataset_generator.py:1016-1068).
  Positions go through a web-mercator projection at a fixed zoom level;
  orientations are roll-free look-at quaternions toward the scene target.
- **KITTI-360**: ``calibration/perspective.txt`` (P_rect_00 / S_rect_00)
  plus ``cam0_to_world.txt`` 4x4 extrinsics (reference: :1088-1135).
  Rotations are re-axised from [Right|Down|Forward] to this repo's
  [Forward|Right|Up] camera convention; translations are voxelized.

All per-frame math is vectorized over the whole trajectory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from gaussiancity_tpu_torch.camera import matrix_to_quat_xyzw

GOOGLE_EARTH_ZOOM_LEVEL = 18
# Empirical Google-Earth-Studio focal correction (reference
# dataset_generator.py:1025 "MAGIC NUMBER to make it aligned with
# Google Earth renderings").
GOOGLE_EARTH_FOCAL_CORRECTION = 2.06
GOOGLE_EARTH_IMAGE_SIZE = (960, 540)  # (W, H) of the published footage
KITTI_360_VOXEL_SIZE = 0.1


def lnglat_to_web_mercator_xy(lng, lat, resolution: float,
                              zoom_level: int = GOOGLE_EARTH_ZOOM_LEVEL,
                              tile_size: int = 256):
    """Slippy-map web-mercator pixel coordinates, scaled by ``resolution``
    (https://wiki.openstreetmap.org/wiki/Slippy_map_tilenames).

    Vectorized; returns float arrays (callers truncate if they need ints).
    """
    lng = np.asarray(lng, np.float64)
    lat = np.asarray(lat, np.float64)
    world = (2.0 ** zoom_level) * tile_size
    x = (lng + 180.0) / 360.0 * world
    y = (1.0 - np.arcsinh(np.tan(np.radians(lat))) / np.pi) / 2.0 * world
    return x * resolution, y * resolution


def look_at_quats(cam_pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Roll-free (z-up) look-at quaternions, vectorized.

    cam_pos [N, 3], target [3] or [N, 3] -> [N, 4] (x, y, z, w) with the
    repo's [F|R|U] column convention (camera.py).
    """
    cam_pos = np.atleast_2d(np.asarray(cam_pos, np.float64))
    fwd = np.broadcast_to(np.asarray(target, np.float64),
                          cam_pos.shape).copy() - cam_pos
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True)
    right = np.cross(np.array([0.0, 0.0, 1.0]), fwd)
    # straight-down view: right is degenerate (fwd || z-up); pick +x
    rn = np.linalg.norm(right, axis=-1, keepdims=True)
    right = np.where(rn > 1e-9, right / np.maximum(rn, 1e-9),
                     np.array([1.0, 0.0, 0.0]))
    up = np.cross(fwd, right)
    R = np.stack([fwd, right, up], axis=-1)  # [N, 3, 3] columns [F|R|U]
    return np.stack([matrix_to_quat_xyzw(r) for r in R])


def recover_google_earth_rig(cam_settings: dict) -> Dict[str, object]:
    """Intrinsics from a Google Earth Studio project json (already loaded).

    The capture height/vfov give the focal length (with the empirical
    2.06 alignment factor); the K is expressed for the capture sensor,
    scaled so that resampling the footage to 960x540 yields the training
    intrinsics. (reference: dataset_generator.py:1020-1038)
    """
    vfov = cam_settings["cameraFrames"][0]["fovVertical"]
    w, h = cam_settings["width"], cam_settings["height"]
    focal = (h / 2.0 / np.tan(np.deg2rad(vfov))
             * GOOGLE_EARTH_FOCAL_CORRECTION)
    iw, ih = GOOGLE_EARTH_IMAGE_SIZE
    K = np.array([
        [focal / (960.0 / iw), 0.0, w // 2],
        [0.0, focal / (540.0 / ih), h // 2],
        [0.0, 0.0, 1.0],
    ])
    return {"intrinsics": K.flatten().tolist(), "sensor_size": [w, h]}


def recover_google_earth_poses(city_dir: str, metadata: dict
                               ) -> Tuple[Dict, List[dict]]:
    """Google Earth capture dir -> (cam_rig, camera_poses rows).

    ``metadata`` carries the city's OSM georeference:
    ``{"resolution", "bounds": {"xmin", "ymin"}, "target": {"x","y","z"}}``
    (produced by the OSM half of the offline pipeline).
    """
    name = os.path.basename(os.path.normpath(city_dir))
    with open(os.path.join(city_dir, f"{name}.json")) as fp:
        cam_settings = json.load(fp)
    rig = recover_google_earth_rig(cam_settings)

    frames = cam_settings["cameraFrames"]
    lng = np.array([f["coordinate"]["longitude"] for f in frames])
    lat = np.array([f["coordinate"]["latitude"] for f in frames])
    alt = np.array([f["coordinate"]["altitude"] for f in frames])
    tx, ty = lnglat_to_web_mercator_xy(lng, lat, metadata["resolution"])
    tx = tx - metadata["bounds"]["xmin"]
    ty = ty - metadata["bounds"]["ymin"]

    tgt = metadata["target"]
    target = np.array([tgt["x"], tgt["y"], tgt["z"]], np.float64)
    quats = look_at_quats(np.stack([tx, ty, alt], axis=-1), target)

    poses = [
        {"id": i,
         "tx": float(tx[i] - target[0]),
         "ty": float(ty[i] - target[1]),
         "tz": float(alt[i]),
         "qx": float(quats[i, 0]), "qy": float(quats[i, 1]),
         "qz": float(quats[i, 2]), "qw": float(quats[i, 3])}
        for i in range(len(frames))
    ]
    return rig, poses


def parse_kitti_perspective(path: str) -> Dict[str, object]:
    """calibration/perspective.txt -> {"intrinsics": K flat, "sensor_size"}.

    cx is mirrored (sensor_w - cx) because the KITTI image x-axis is
    flipped relative to the projection maps (reference: :1100-1106).
    """
    K = None
    size = None
    with open(path) as fp:
        for line in fp:
            fields = line.split()
            if not fields:
                continue
            if fields[0] == "P_rect_00:":
                K = np.array(fields[1:], np.float64).reshape(3, 4)[:3, :3]
            elif fields[0] == "S_rect_00:":
                size = [int(float(fields[1])), int(float(fields[2]))]
    if K is None or size is None:
        raise ValueError(f"P_rect_00/S_rect_00 missing in {path}")
    K = K.copy()
    K[0, 2] = size[0] - K[0, 2]
    return {"intrinsics": K.flatten().tolist(), "sensor_size": size}


def recover_kitti_360_poses(city_dir: str, metadata: dict
                            ) -> Tuple[Dict, List[dict]]:
    """KITTI-360 sequence dir -> (cam_rig, camera_poses rows).

    Expects the standard layout: ``<root>/calibration/perspective.txt``
    two levels above the sequence dir, and ``cam0_to_world.txt`` inside.
    """
    rig = parse_kitti_perspective(os.path.join(
        city_dir, os.pardir, os.pardir, "calibration", "perspective.txt"))

    rows = np.loadtxt(os.path.join(city_dir, "cam0_to_world.txt"))
    rows = np.atleast_2d(rows)
    ids = rows[:, 0].astype(int)
    Rt = rows[:, 1:].reshape(-1, 4, 4)
    # [Right|Down|Forward] columns -> [Forward|Right|Up(=-Down)]; the
    # reference keeps Down un-negated (its maps are y-down), reproduce that.
    R = Rt[:, :3, [2, 0, 1]]
    quats = np.stack([matrix_to_quat_xyzw(r) for r in R])
    t = Rt[:, :3, 3] / KITTI_360_VOXEL_SIZE
    b = metadata["bounds"]
    t = t - np.array([b["xmin"], b["ymin"], b.get("zmin", 0.0)])

    poses = [
        {"id": int(ids[i]),
         "tx": float(t[i, 0]), "ty": float(t[i, 1]), "tz": float(t[i, 2]),
         "qx": float(quats[i, 0]), "qy": float(quats[i, 1]),
         "qz": float(quats[i, 2]), "qw": float(quats[i, 3])}
        for i in range(len(ids))
    ]
    return rig, poses


def recover_camera_parameters(dataset: str, city_dir: str, metadata: dict):
    """(reference: scripts/dataset_generator.py:1007-1014)"""
    if dataset == "GOOGLE_EARTH":
        return recover_google_earth_poses(city_dir, metadata)
    if dataset == "KITTI_360":
        return recover_kitti_360_poses(city_dir, metadata)
    raise ValueError(f"Unknown dataset: {dataset}")
