# -*- coding: utf-8 -*-
"""Dataset generation from projection maps (counterpart of
``gaussiancity_tpu/data/dataset_generator.py``; upstream
scripts/dataset_generator.py).

Per city: ``Projection/*.png`` -> ``CENTERS.pkl`` and, per camera pose of
``CameraPoses.csv``, ``InstanceImage/%0Nd.png`` and ``Points/%0Nd.pkl``
({prj: local TD_HF / SEG [/ tlp], vpm, msk, pts [N, 5]}), the files that
``data.datasets.GoogleEarthDataset`` reads.

Per view the device extrudes the footprints (``ops.extrusion``, kernel
E1 on a CUDA device), builds the id volume and raycasts it (``visibility.
get_visible_points``: the volume scatter, then kernel V1) and reindexes
the visible points; only what the Points pkl holds comes back.  The host
keeps the frustum, the local projection windows and the file writes.
The raw-capture ingest that makes the projection maps is in
``osm_ingest`` / ``kitti_ingest``, and the per-city entry point in
``generate_dataset``."""

from __future__ import annotations

import csv
import logging
import math
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gaussiancity_tpu_torch.camera import (intrinsic_to_fov,
                                           quat_xyzw_to_matrix)
from gaussiancity_tpu_torch.device import resolve_device
from gaussiancity_tpu_torch.ops import visibility as vis
from gaussiancity_tpu_torch.ops.extrusion import (SegInsRelation,
                                                  extrude_points_exact)

# (upstream dataset_generator.py:42-118)
CLASSES = {
    "GOOGLE_EARTH": {
        "NULL": 0, "ROAD": 1, "BLDG_FACADE": 2, "GREEN_LANDS": 3,
        "CONSTRUCTION": 4, "WATER": 5, "ZONE": 6, "BLDG_ROOF": 7,
    },
    "KITTI_360": {
        "NULL": 0, "ROAD": 1, "BLDG_FACADE": 2, "CAR": 3, "VEGETATION": 4,
        "SKY": 5, "ZONE": 6, "BLDG_ROOF": 7,
    },
}
SCALES = {
    "GOOGLE_EARTH": {"ROAD": 2, "BLDG_FACADE": 1, "BLDG_ROOF": 1,
                     "GREEN_LANDS": 2, "CONSTRUCTION": 1, "WATER": 4,
                     "ZONE": 2},
    "KITTI_360": {"ROAD": 2, "BLDG_FACADE": 1, "CAR": 1, "VEGETATION": 1,
                  "SKY": 4, "ZONE": 2, "BLDG_ROOF": 1},
}
CONSTANTS = {
    "GOOGLE_EARTH": {
        "SCALE": 1, "WATER_Z": 0, "MAP_SIZE": 2048, "PATCH_SIZE": 2048,
        "PROJECTION_SIZE": 2048, "BLDG_INST_RANGE": [100, 16384],
        "IMAGE_WIDTH": 960, "IMAGE_HEIGHT": 540,
        "SEG_MAP_PATTERN": "seg/%s_%02d.png",
        "OUT_FILE_NAME_PATTERN": "%04d",
    },
    "KITTI_360": {
        "SCALE": 1, "MAP_SIZE": 0, "PATCH_SIZE": 1280,
        "PROJECTION_SIZE": 2048, "BLDG_INST_RANGE": [100, 10000],
        "CAR_INST_RANGE": [10000, 16384],
        "SEG_MAP_PATTERN": "seg/%010d.png",
        "OUT_FILE_NAME_PATTERN": "%010d",
    },
    "ROOF_INS_OFFSET": 1,
}


def class_scale_table(dataset: str) -> Tuple[int, ...]:
    """Extrusion scale per class id (1 for a class without one)."""
    table = [1] * len(CLASSES[dataset])
    for name, cid in CLASSES[dataset].items():
        table[cid] = SCALES[dataset].get(name, 1)
    return tuple(table)


def get_seg_ins_relations(dataset: str) -> SegInsRelation:
    """(upstream dataset_generator.py:984-1005)"""
    c = CONSTANTS[dataset]
    cls = CLASSES[dataset]
    return SegInsRelation(
        bldg_ins_min_id=c["BLDG_INST_RANGE"][0],
        roof_ins_offset=CONSTANTS["ROOF_INS_OFFSET"],
        bldg_facade_semantic_id=cls["BLDG_FACADE"],
        bldg_roof_semantic_id=cls.get("BLDG_ROOF", cls["BLDG_FACADE"]),
        car_ins_min_id=c.get("CAR_INST_RANGE", [32767])[0],
        car_semantic_id=cls.get("CAR", 32767),
    )


_CATEGORIES = ("CAR", "FWY", "VEGT", "REST")
_MAP_NAMES = ("INS", "SEG", "TD_HF", "BU_HF", "PTS")


def load_projections(proj_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """``<category>-<map>.png`` files -> {category: {map: int16 array}}
    (upstream dataset_generator.py:909-933)."""
    from PIL import Image

    projections: Dict[str, Dict[str, np.ndarray]] = {}
    for c in _CATEGORIES:
        for m in _MAP_NAMES:
            path = os.path.join(proj_dir, f"{c}-{m}.png")
            if os.path.exists(path):
                with Image.open(path) as img:
                    projections.setdefault(c, {})[m] = np.array(
                        img).astype(np.int16)
    return projections


def dump_projections(projections, proj_dir: str) -> None:
    """Each map as a 16-bit grey PNG (upstream dataset_generator.py
    :891-906)."""
    from PIL import Image

    os.makedirs(proj_dir, exist_ok=True)
    for c, maps in projections.items():
        for m, arr in maps.items():
            Image.fromarray(np.asarray(arr).astype(np.uint16)).save(
                os.path.join(proj_dir, f"{c}-{m}.png"))


def get_centers_from_projections(dataset: str, projections
                                 ) -> Dict[int, np.ndarray]:
    """Per-instance centres {id: [cx, cy, w, h, max_z]} (float32).

    A building gets the bounding box of its footprint pixels and its
    highest pixel + 1, mirrored to its roof id (facade + 1); every other
    id (and KITTI-360's sky) spans the whole map at the map's highest
    pixel, the largest over the categories that hold it."""
    bldg_min, bldg_max = CONSTANTS[dataset]["BLDG_INST_RANGE"]
    sky_id = CLASSES[dataset].get("SKY")
    centers: Dict[int, np.ndarray] = {}
    for p in projections.values():
        H, W = p["INS"].shape
        ids, label = np.unique(p["INS"].ravel(), return_inverse=True)
        n = len(ids)
        cols = np.tile(np.arange(W), H)
        rows = np.repeat(np.arange(H), W)
        x_lo = np.full(n, W, np.int64)
        x_hi = np.full(n, -1, np.int64)
        y_lo = np.full(n, H, np.int64)
        y_hi = np.full(n, -1, np.int64)
        z_hi = np.full(n, np.iinfo(np.int64).min)
        np.minimum.at(x_lo, label, cols)
        np.maximum.at(x_hi, label, cols)
        np.minimum.at(y_lo, label, rows)
        np.maximum.at(y_hi, label, rows)
        np.maximum.at(z_hi, label, p["TD_HF"].ravel().astype(np.int64))
        map_z = float(p["TD_HF"].max())

        stuff = {int(i) for i in ids if i < bldg_min}
        if sky_id is not None:
            stuff.add(sky_id)
        for i in sorted(stuff):
            z = map_z if i not in centers else max(map_z, centers[i][-1])
            centers[i] = np.array([W / 2, H / 2, W, H, z], np.float32)
        for k in np.flatnonzero(ids >= bldg_min):
            i = int(ids[k])
            centers[i] = np.array(
                [(x_lo[k] + x_hi[k]) / 2, (y_lo[k] + y_hi[k]) / 2,
                 x_hi[k] - x_lo[k], y_hi[k] - y_lo[k], z_hi[k] + 1],
                np.float32)
            if i < bldg_max:
                centers[i + 1] = centers[i]
    return centers


def get_view_frustum_cords(cam_pos, cam_look_at, patch_size: int,
                           fov_rad: float) -> np.ndarray:
    """The view frustum's 2-D footprint as 5 int16 points: the camera,
    the far edge's two ends (at forward distance ``patch_size``, lateral
    offset ``patch_size * tan(fov_rad)``), then their mirror images
    through the rectangle's centre (upstream dataset_generator.py
    :1157-1195)."""
    p1 = np.asarray(cam_pos, np.float64)[:2]
    d = np.asarray(cam_look_at, np.float64)[:2] - p1
    d /= np.linalg.norm(d)
    n = np.array([-d[1], d[0]])
    far_mid = p1 + patch_size * d
    half_w = patch_size * math.tan(fov_rad)
    far_a = far_mid + half_w * n
    far_b = far_mid - half_w * n
    center2 = p1 + far_mid  # twice the rectangle's centre
    return np.array([p1, far_a, far_b, center2 - far_a, center2 - far_b]
                    ).astype(np.int16)


def get_local_projections(projections, local_cords, map_size: int):
    """Per-view conditioning maps: a ``map_size`` window around the view
    frustum (the whole map where ``local_cords`` is None), resized to
    ``map_size`` (SEG nearest, TD_HF by area).  Off the map's low edge the
    window is zero-padded, off the high edge clipped; ``tlp`` is its top
    left corner clamped into the map (upstream dataset_generator.py
    :1198-1248, one window for both maps)."""
    import cv2

    specs = (("SEG", np.uint8, cv2.INTER_NEAREST),
             ("TD_HF", np.float32, cv2.INTER_AREA))
    local = {}
    for name, dtype, interp in specs:
        full = projections[name]
        if local_cords is None:
            win = full.astype(dtype)
        else:
            anchor = np.asarray(local_cords[:3], np.float64)
            cx, cy = np.mean(anchor, axis=0).astype(np.int32)
            x0, y0 = int(cx) - map_size // 2, int(cy) - map_size // 2
            xs, ys = max(0, x0), max(0, y0)
            win = full[ys: y0 + map_size, xs: x0 + map_size]
            win = np.pad(win, ((ys - y0, 0), (xs - x0, 0))).astype(dtype)
            local["tlp"] = np.array([xs, ys])
        local[name] = cv2.resize(win, (map_size, map_size),
                                 interpolation=interp)
    return local


def get_sky_points(far_plane, cam_z, cam_fov_y, patch_size, scale, class_id):
    """Sky wall: a lattice of ``class_id`` points along the far edge
    ``far_plane`` (two points), over the heights the camera's vertical
    field of view reaches; int16 [S * Z, 5] (upstream dataset_generator.py
    :1334-1351)."""
    a, b = np.asarray(far_plane, np.float64)[:2]
    edge_len = float(np.linalg.norm(b - a))
    steps = np.arange(math.ceil(edge_len / scale), dtype=np.float64)
    xy = a + steps[:, None] * (scale / edge_len) * (b - a)
    band = patch_size * math.tan(cam_fov_y)
    zs = np.arange(math.floor(max(0, cam_z - band)),
                   math.ceil(cam_z + band) + 1, scale)
    out = np.empty((len(steps), len(zs), 5), np.float64)
    out[..., 0:2] = xy[:, None, :]
    out[..., 2] = zs[None, :]
    out[..., 3] = scale
    out[..., 4] = class_id
    return out.reshape(-1, 5).astype(np.int16)


def get_points_from_projections(dataset: str, projections,
                                local_cords=None, device=None
                                ) -> torch.Tensor:
    """Extrude every category on ``device`` (the card unless the caller
    asks for the CPU) -> [N, 5] int32 (x, y, z, scale, instance) there,
    inside the frustum ``local_cords`` where given; water points sit on
    the water plane (upstream dataset_generator.py:1251-1331).  Each
    category's maps (or their frustum crop, its ``fillPoly`` mask applied
    to PTS on the host) are uploaded as they are and PTS as a bool mask,
    and extruded by kernel E1 (``extrusion.extrude_points_exact``)."""
    import cv2

    device = resolve_device(device)
    rel = get_seg_ins_relations(dataset)
    table = class_scale_table(dataset)
    water_z = CONSTANTS[dataset].get("WATER_Z", 0)
    out = []
    for c, p in projections.items():
        maps = p
        off_x = off_y = 0
        if local_cords is not None:
            min_x = math.floor(np.min(local_cords[:, 0]))
            max_x = math.ceil(np.max(local_cords[:, 0]))
            min_y = math.floor(np.min(local_cords[:, 1]))
            max_y = math.ceil(np.max(local_cords[:, 1]))
            if min_x < 0:
                max_x -= min_x
                min_x = 0
            if min_y < 0:
                max_y -= min_y
                min_y = 0
            maps = {k: np.ascontiguousarray(
                v[min_y:max_y, min_x:max_x]).astype(np.int16)
                for k, v in p.items()}
            mask = np.zeros_like(maps["PTS"], dtype=np.int16)
            cv2.fillPoly(mask, [np.array(
                local_cords - np.array([min_x, min_y]), dtype=np.int32)], 1)
            maps["PTS"] = maps["PTS"] * mask
            off_x, off_y = min_x, min_y

        ins, td, bu, msk = (torch.as_tensor(np.ascontiguousarray(m),
                                            device=device)
                            for m in (maps["INS"], maps["TD_HF"],
                                      maps["BU_HF"], maps["PTS"] != 0))
        pts = extrude_points_exact(ins, td, bu, msk, rel, table,
                                   include_btm_pts=c != "REST")
        if len(pts):
            pts[:, 0] += off_x
            pts[:, 1] += off_y
            if c == "REST" and "WATER" in CLASSES[dataset]:
                pts[pts[:, 4] == CLASSES[dataset]["WATER"], 2] = water_z
            out.append(pts)
    return (torch.cat(out) if out
            else torch.zeros((0, 5), dtype=torch.int32, device=device))


def get_seg_map_from_ins_map(dataset: str, ins_map: np.ndarray) -> np.ndarray:
    """Instance map -> semantic map: building ids even -> facade, odd ->
    roof, and the car range -> car."""
    c = CONSTANTS[dataset]
    cls = CLASSES[dataset]
    out = ins_map.astype(np.int64).copy()
    lo, hi = c["BLDG_INST_RANGE"]
    in_bldg = (out >= lo) & (out < hi)
    out[in_bldg & (out % 2 == 0)] = cls["BLDG_FACADE"]
    out[in_bldg & (out % 2 == 1)] = cls["BLDG_ROOF"]
    if "CAR_INST_RANGE" in c:
        lo, hi = c["CAR_INST_RANGE"]
        out[(out >= lo) & (out < hi)] = cls["CAR"]
    return out


def generate_view(dataset: str, projections, cam_pos, cam_quat,
                  vol_shape=(640, 640, 256),
                  seg_map: Optional[np.ndarray] = None, device=None):
    """One view on ``device`` (the card unless the caller asks for the
    CPU): extrusion (kernel E1), the id volume, its raycast (kernel V1)
    and the visible points reindexed, copied back only as the Points pkl
    holds them (upstream dataset_generator.py:1545-1686).

    Returns ({prj, vpm, msk, pts}, the Points pkl's schema; the instance
    map [H, W])."""
    device = resolve_device(device)
    c = CONSTANTS[dataset]
    cam_look_at = np.asarray(cam_pos[:3], np.float64) + look_dir(
        cam_quat) * 1000
    frustum = None
    if dataset == "KITTI_360":
        frustum = get_view_frustum_cords(
            cam_pos, cam_look_at, c["PATCH_SIZE"],
            helpers_intrinsic_fov(dataset, 0) / 2)

    local = get_local_projections(
        projections["REST"], frustum, c["PROJECTION_SIZE"])
    points = get_points_from_projections(dataset, projections, frustum,
                                         device)

    mins = points[:, :3].min(0).values
    K = camera_intrinsics(dataset)
    W, H = sensor_size(dataset)
    f32 = dict(dtype=torch.float32, device=device)
    vp_map, ins_map = vis.get_visible_points(
        points, points[:, 3:4].expand(-1, 3),
        torch.as_tensor(np.asarray(cam_pos, np.float32), **f32),
        torch.as_tensor(np.asarray(cam_quat, np.float32), **f32),
        float(K[0, 0]), (float(K[1, 2]), float(K[0, 2])), (H, W), vol_shape,
        mins - torch.tensor([0, 0, 1], dtype=mins.dtype, device=device))
    if dataset == "KITTI_360":
        vp_map = torch.flip(vp_map, [1])
        ins_map = torch.flip(ins_map, [1])

    vp_idx = torch.unique(vp_map)
    vp_idx = vp_idx[vp_idx >= 0]
    vpm = torch.searchsorted(vp_idx, vp_map.contiguous())
    ins_map = ins_map.cpu().numpy()
    msk = (get_seg_map_from_ins_map(dataset, ins_map) == seg_map
           if seg_map is not None
           else np.ones_like(ins_map, dtype=bool))
    return {
        "prj": local,
        "vpm": vpm.cpu().numpy(),
        "msk": msk,
        "pts": points[vp_idx.long()].long().cpu().numpy(),
    }, ins_map


# --- camera helpers -------------------------------------------------------

_DEFAULT_K = {
    "GOOGLE_EARTH": np.array(
        [[1528.1469407006614, 0, 480], [0, 1528.1469407006614, 270],
         [0, 0, 1]]),
    "KITTI_360": np.array(
        [[552.554261, 0, 682.049453], [0, 552.554261, 238.769549],
         [0, 0, 1]]),
}
_SENSORS = {"GOOGLE_EARTH": (960, 540), "KITTI_360": (1408, 376)}


def camera_intrinsics(dataset: str) -> np.ndarray:
    return _DEFAULT_K[dataset]


def sensor_size(dataset: str) -> Tuple[int, int]:
    """(W, H)"""
    return _SENSORS[dataset]


def helpers_intrinsic_fov(dataset: str, axis: int) -> float:
    return intrinsic_to_fov(_DEFAULT_K[dataset][axis, axis],
                            _SENSORS[dataset][axis])


def look_dir(cam_quat) -> np.ndarray:
    """The camera's forward axis: its rotation's first column."""
    return quat_xyzw_to_matrix(np.asarray(cam_quat, np.float64))[:, 0]


def save_camera_poses(path: str, cam_poses: List[dict]) -> None:
    with open(path, "w", newline="") as fp:
        w = csv.DictWriter(fp, fieldnames=["id", "tx", "ty", "tz",
                                           "qx", "qy", "qz", "qw"])
        w.writeheader()
        w.writerows(cam_poses)


def generate_city(dataset: str, city_dir: str,
                  cam_poses: Optional[List[dict]] = None,
                  vol_shape=(640, 640, 256), device=None) -> None:
    """One city directory: ``Projection/*.png`` (and ``CameraPoses.csv``
    unless ``cam_poses`` is given) -> ``CENTERS.pkl``, ``InstanceImage/``
    and ``Points/``, the views raycast on ``device`` (the card unless the
    caller asks for the CPU)."""
    from PIL import Image

    device = resolve_device(device)
    projections = load_projections(os.path.join(city_dir, "Projection"))
    centers = get_centers_from_projections(dataset, projections)
    with open(os.path.join(city_dir, "CENTERS.pkl"), "wb") as fp:
        pickle.dump(centers, fp)

    if cam_poses is None:
        with open(os.path.join(city_dir, "CameraPoses.csv")) as fp:
            cam_poses = [dict(r) for r in csv.DictReader(fp)]

    ins_dir = os.path.join(city_dir, "InstanceImage")
    pts_dir = os.path.join(city_dir, "Points")
    os.makedirs(ins_dir, exist_ok=True)
    os.makedirs(pts_dir, exist_ok=True)
    pattern = CONSTANTS[dataset]["OUT_FILE_NAME_PATTERN"]
    for r in cam_poses:
        cam_pos = np.array([float(r[k]) for k in ("tx", "ty", "tz")])
        cam_quat = np.array([float(r[k]) for k in ("qx", "qy", "qz", "qw")])
        data, ins_map = generate_view(dataset, projections, cam_pos,
                                      cam_quat, vol_shape, device=device)
        name = pattern % int(float(r["id"]))
        Image.fromarray(ins_map.astype(np.uint16)).save(
            os.path.join(ins_dir, f"{name}.png"))
        with open(os.path.join(pts_dir, f"{name}.pkl"), "wb") as fp:
            pickle.dump(data, fp)
        logging.info("view %s: %d points", name, len(data["pts"]))
