# -*- coding: utf-8 -*-
"""City generation inference pipeline (counterpart of
``gaussiancity_tpu/inference/pipeline.py``; upstream scripts/inference.py).

Per trajectory: BEV point extrusion (host) -> id volume (device, once per
point set).  Per frame: first-hit raycast (kernel V1) -> visible points in
ascending point order -> per-instance coordinates (host) -> per-class
attribute prediction (generators) -> 14-channel pack -> rasterizer
(kernel K1) -> road blur composite -> uint8 frame.

Two ways to run the generators, as in the JAX package: the dense path
evaluates every model on all visible points and selects attributes by
class mask; the compact path (``class_budgets``) gives each model only its
own class's points, nearest first within its budget.  The port runs each
model on exactly its points: the JAX package's padding to static slab
sizes is a compile-time device the port does not need.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gaussiancity_tpu_torch.camera import CameraModel, matrix_to_quat_xyzw
from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.data import dataset_generator as dg
from gaussiancity_tpu_torch.data.datasets import instances_to_classes_np
from gaussiancity_tpu_torch.data.transforms import _normalize_rel_cords
from gaussiancity_tpu_torch.device import resolve_device
from gaussiancity_tpu_torch.ops import extrusion as ext
from gaussiancity_tpu_torch.ops import visibility as vis
from gaussiancity_tpu_torch.ops.rasterizer import rasterize_points14
from gaussiancity_tpu_torch.utils import helpers


def get_quat_from_look_at(cam_pos: np.ndarray, look_at: np.ndarray):
    """Roll-free (z-up) orientation whose forward axis points from
    ``cam_pos`` at ``look_at``, as an (x, y, z, w) quaternion; rotation
    columns follow the camera convention [F|R|U]."""
    f = np.subtract(look_at, cam_pos).astype(np.float64)
    f /= np.linalg.norm(f)
    r = np.cross([0.0, 0.0, 1.0], f)
    r /= np.linalg.norm(r)
    return matrix_to_quat_xyzw(np.column_stack([f, r, np.cross(f, r)]))


def get_orbit_camera_poses(proj_size: int, n_points: int = 24,
                           radius: Optional[int] = None,
                           altitude: Optional[int] = None,
                           rng: Optional[np.random.Generator] = None,
                           center: Optional[Tuple[int, int]] = None):
    """Orbit trajectory around the map centre (or ``center=(cx, cy)``)."""
    rng = rng or np.random.default_rng()
    radius = radius if radius is not None else int(rng.integers(256, 768))
    altitude = (altitude if altitude is not None
                else int(rng.integers(512, 768)))
    cx, cy = center if center is not None else (proj_size // 2,) * 2
    poses = []
    for i in range(n_points):
        theta = 2 * math.pi / n_points * i
        cam_x = cx + radius * math.cos(theta)
        cam_y = cy + radius * math.sin(theta)
        quat = get_quat_from_look_at(
            np.array([cam_x, cam_y, altitude]), np.array([cx, cy, 1.0]))
        poses.append({
            "id": i, "tx": cam_x, "ty": cam_y, "tz": altitude,
            "qx": quat[0], "qy": quat[1], "qz": quat[2], "qw": quat[3],
        })
    return poses


def get_style_lut(centers: Dict[int, tuple], z_dim: int = 256,
                  z_bank: Optional[Dict[int, np.ndarray]] = None,
                  seed: int = 0,
                  max_instances: int = helpers.MAX_N_INSTANCES
                  ) -> np.ndarray:
    """Per-instance style table [max_instances, z_dim], U[0, 1)."""
    rng = np.random.default_rng(seed)
    lut = rng.random((max_instances, z_dim)).astype(np.float32)
    if z_bank:
        for ins, z in z_bank.items():
            lut[int(ins) % max_instances] = np.asarray(z, np.float32)
    return lut


def select_nearest_rows(pts9: np.ndarray, cam_pos: np.ndarray,
                        budget: int):
    """Keep the ``budget`` points nearest to the camera, original order
    preserved.  Returns (kept rows [<= budget, 9], n_dropped)."""
    n = len(pts9)
    if n <= budget:
        return pts9, 0
    d2 = np.sum(
        (pts9[:, :3] - np.asarray(cam_pos, np.float32)[None]) ** 2, 1)
    keep = np.sort(np.argpartition(d2, budget - 1)[:budget])
    return pts9[keep], n - budget


def select_nearest(pts9: np.ndarray, cam_pos: np.ndarray, budget: int):
    """``select_nearest_rows`` zero-padded to the budget.  Returns
    (padded [budget, 9], mask [budget], n_dropped)."""
    rows, n_dropped = select_nearest_rows(pts9, cam_pos, budget)
    pad = np.zeros((budget, pts9.shape[1]), np.float32)
    pad[:len(rows)] = rows
    return pad, np.arange(budget) < len(rows), n_dropped


def _gaussian_blur3(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """3x3 Gaussian blur of one [H, W, C] image with reflect padding
    (torchvision GaussianBlur(3, sigma) semantics)."""
    x = np.arange(-1, 2, dtype=np.float32)
    k1 = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k1 /= k1.sum()
    C = img.shape[-1]
    k = torch.as_tensor(np.outer(k1, k1), device=img.device)
    padded = F.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="reflect")
    out = F.conv2d(padded, k.expand(C, 1, 3, 3), groups=C)
    return out[0].permute(1, 2, 0)


def frame_to_uint8(img: torch.Tensor) -> np.ndarray:
    """[-1, 1] float frame -> uint8 numpy (truncating, as the JAX
    package's cast does)."""
    return (torch.clamp(img / 2 + 0.5, 0, 1) * 255).to(
        torch.uint8).cpu().numpy()


def write_video(path: str, frames: List[np.ndarray], fps: int = 4) -> None:
    """mp4 writer (needs OpenCV, imported only here)."""
    import os

    import cv2

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"cv2.VideoWriter could not open {path}")
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


class InferencePipeline:
    """Holds the per-class generators and renders camera trajectories.

    ``models`` maps a class name ("REST", "BLDG", "CAR") to a generator
    module with its weights.  ``class_budgets`` (name -> point budget)
    selects the compact per-class path.  ``stage_ms`` collects per-stage
    wall times (device synchronised at each stage boundary; on the compact
    path ``generator`` is split per model into ``generator_<name>``) and
    ``frame_stats`` the visible count (per model ``n_<name>`` on the
    compact path) and rasterizer counters of every frame rendered."""

    def __init__(self, cfg: Config, models: Dict[str, torch.nn.Module],
                 max_points: int = 262144,
                 vol_shape: Tuple[int, int, int] = (512, 512, 192),
                 class_budgets: Optional[Dict[str, int]] = None,
                 device=None):
        if not models:
            raise ValueError("no models given")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ds = cfg.dataset
        self.models = {n: m.to(self.device).eval() for n, m in models.items()}
        self.max_points = max_points
        self.vol_shape = vol_shape
        self.class_budgets = class_budgets
        self.camera = CameraModel(
            np.asarray(self.ds.cam_k).reshape(3, 3), self.ds.sensor_size)
        self._pts_fp = None
        self.stage_ms: Dict[str, List[float]] = {}
        self.frame_stats: List[Dict[str, int]] = []

    # ------------------------------------------------------------------
    # timing
    # ------------------------------------------------------------------

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _record(self, stage: str, t0: float) -> float:
        t1 = self._now()
        self.stage_ms.setdefault(stage, []).append((t1 - t0) * 1e3)
        return t1

    # ------------------------------------------------------------------
    # point generation and visibility
    # ------------------------------------------------------------------

    def build_points(self, projections: Dict[str, Dict[str, np.ndarray]],
                     water_z: int = 0) -> np.ndarray:
        """Extrude all projection categories on the pipeline's device
        (kernel E1 on the card, ``extrusion.extrude_points_exact``) ->
        [N, 5] int32 (x, y, z, scale, instance) on the host."""
        ds = self.ds
        rel = ext.SegInsRelation(
            bldg_ins_min_id=ds.bldg_range[0],
            bldg_facade_semantic_id=ds.bldg_facade_clsid,
            bldg_roof_semantic_id=ds.bldg_roof_clsid,
            car_ins_min_id=ds.car_range[0] if ds.car_range else 32767,
            car_semantic_id=ds.car_clsid if ds.car_clsid else 32767)
        scales_tab = dg.class_scale_table(
            "KITTI_360" if ds.name == "KITTI_360" else "GOOGLE_EARTH")
        all_pts = []
        for c, p in projections.items():
            maps = [np.ascontiguousarray(p[k]) for k in ("INS", "TD_HF",
                                                          "BU_HF")]
            maps = [torch.as_tensor(
                m if m.dtype == np.int16 else m.astype(np.int32, copy=False),
                device=self.device) for m in maps]
            maps.append(torch.as_tensor(np.asarray(p["PTS"]) != 0,
                                        device=self.device))
            pts = ext.extrude_points_exact(*maps, rel, scales_tab,
                                           include_btm_pts=(c != "REST"))
            if c == "REST":
                pts[pts[:, 4] == 5, 2] = water_z  # WATER class id
            all_pts.append(pts)
        return torch.cat(all_pts).cpu().numpy()

    def _volume_origin(self, points: np.ndarray) -> np.ndarray:
        mins = points[:, :3].min(0)
        return np.array([mins[0], mins[1], mins[2] - 1], np.int32)

    def build_volume(self, points: np.ndarray) -> None:
        """Build (or keep) the id volume of ``points`` and its occupancy
        tables (``vis.pack_occupancy``, which the raycast reads).  They
        depend only on the points, so trajectories build them once; a
        sampled-row fingerprint notices a changed point set."""
        stride = max(1, len(points) // 97)
        fp = (points.shape, points.dtype.str, points[::stride].tobytes(),
              int(points[:, :3].sum()))
        if self._pts_fp == fp:
            return
        h, w, d = self.vol_shape
        pts = torch.as_tensor(np.asarray(points, np.int32),
                              device=self.device)
        scales3 = helpers.get_point_scales(
            pts[:, 3:4].float(), pts[:, 4]).to(torch.int32)
        offsets = torch.as_tensor(self._volume_origin(points),
                                  device=self.device)
        ids = torch.arange(1, len(points) + 1, dtype=torch.int32,
                           device=self.device)
        self._vol = vis.points_to_volume(pts[:, :3] - offsets, ids, scales3,
                                         h, w, d)
        self._occ = vis.pack_occupancy(self._vol)
        self._pts_dev = pts
        self._offsets = offsets
        self._pts_fp = fp

    def visible_points(self, points: np.ndarray, cam_pos: np.ndarray,
                       cam_quat: np.ndarray
                       ) -> Tuple[np.ndarray, torch.Tensor]:
        """(visible points [M, 5] in ascending point order, road mask
        [H, W] bool on the device)."""
        self.build_volume(points)
        W, H = self.ds.sensor_size
        K = np.asarray(self.ds.cam_k).reshape(3, 3)
        f32 = dict(dtype=torch.float32, device=self.device)
        vp_map, ins_map = vis.visible_from_volume(
            self._vol, self._pts_dev, torch.as_tensor(cam_pos, **f32),
            torch.as_tensor(cam_quat, **f32), cam_f=float(K[0, 0]),
            cam_c=(float(K[1, 2]), float(K[0, 2])), img_dims=(H, W),
            offsets=self._offsets, occupancy=self._occ)
        vp_idx = torch.unique(vp_map[vp_map >= 0]).cpu().numpy()
        return points[vp_idx], ins_map == 1  # ROAD class id

    def normalize_points(self, pts: np.ndarray, centers) -> np.ndarray:
        """[N, 5] -> [N, 9] with per-instance coords + batch index."""
        rel_bidx = _normalize_rel_cords(pts, centers)
        return np.concatenate([pts.astype(np.float32), rel_bidx], axis=1)

    def host_class_split(self, pts9: np.ndarray) -> Dict[str, np.ndarray]:
        """Class membership per model name, on the host."""
        ds = self.ds
        classes = instances_to_classes_np(pts9[:, 4].astype(np.int64), ds)
        bldg = np.zeros(len(pts9), bool)
        car = np.zeros(len(pts9), bool)
        if "BLDG" in self.models:
            bldg = np.isin(classes,
                           [ds.bldg_facade_clsid, ds.bldg_roof_clsid])
        if "CAR" in self.models and ds.car_clsid is not None:
            car = classes == ds.car_clsid
        return {"BLDG": bldg, "CAR": car, "REST": ~(bldg | car)}

    # ------------------------------------------------------------------
    # device stages
    # ------------------------------------------------------------------

    def _class_masks(self, classes: torch.Tensor) -> Dict[str, torch.Tensor]:
        bldg = torch.zeros_like(classes, dtype=torch.bool)
        car = torch.zeros_like(classes, dtype=torch.bool)
        if "BLDG" in self.models:
            bldg = torch.isin(classes, torch.tensor(
                [self.ds.bldg_facade_clsid, self.ds.bldg_roof_clsid],
                device=classes.device))
        if "CAR" in self.models and self.ds.car_clsid is not None:
            car = classes == self.ds.car_clsid
        return {"BLDG": bldg, "CAR": car, "REST": ~(bldg | car)}

    def _point_features(self, pts9: torch.Tensor, proj_tlp, style_lut):
        ds = self.ds
        pts = pts9[None]
        abs_xyz = pts[..., 0:3]
        rel_xyz = pts[..., 5:8]
        instances = pts[..., 4].to(torch.int32)
        classes = helpers.instances_to_classes(
            instances, ds.bldg_range, ds.bldg_facade_clsid,
            ds.bldg_roof_clsid, ds.car_range, ds.car_clsid)
        scales = pts[..., 3:4] * self.cfg.network.scale_factor
        scales3 = helpers.get_point_scales(scales, classes,
                                           ds.z_scale_special_classes)
        onehots = helpers.get_one_hot(classes, ds.n_classes)
        proj_uv = helpers.get_projection_uv(
            abs_xyz, proj_tlp[None] if proj_tlp is not None else None,
            ds.proj_size)
        z_pts = style_lut[(instances[0] % style_lut.shape[0]).long()][None]
        return abs_xyz, rel_xyz, classes, scales3, onehots, proj_uv, z_pts

    def _apply_model(self, module, proj_uv, rel_xyz, onehots, z_pts,
                     proj_hf, proj_seg, pts_mask=None):
        z_in = z_pts if module.cfg.z_dim is not None else None
        mask = (pts_mask[None] if pts_mask is not None else
                torch.ones(rel_xyz.shape[:2], dtype=torch.bool,
                           device=rel_xyz.device))
        return module(proj_uv, rel_xyz, None, onehots, z_in, proj_hf[None],
                      proj_seg[None], mask)

    def predict_attrs(self, pts9: torch.Tensor, proj_hf: torch.Tensor,
                      proj_seg: torch.Tensor, proj_tlp, style_lut
                      ) -> torch.Tensor:
        """Dense path: every model evaluates all points; attributes are
        selected by class mask.  pts9 [n, 9] -> Gaussians [n, 14]."""
        (abs_xyz, rel_xyz, classes, scales3, onehots, proj_uv,
         z_pts) = self._point_features(pts9, proj_tlp, style_lut)
        masks = self._class_masks(classes[0])
        attrs: Dict[str, torch.Tensor] = {}
        for name, module in self.models.items():
            out = self._apply_model(module, proj_uv, rel_xyz, onehots,
                                    z_pts, proj_hf, proj_seg)
            m = masks[name][None, :, None]
            for k, v in out.items():
                prev = attrs.get(k)
                attrs[k] = torch.where(
                    m, v, prev if prev is not None else torch.zeros_like(v))
        return helpers.get_gaussian_points(abs_xyz, scales3, attrs)[0]

    def predict_attrs_single(self, name: str, pts9: torch.Tensor,
                             proj_hf: torch.Tensor, proj_seg: torch.Tensor,
                             proj_tlp, style_lut,
                             pts_mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
        """Compact path: one model over its own class's points.
        ``pts_mask`` [n] marks the real rows of a padded slab (PTv3 leaves
        the others out of its serialisation, pooling, attention and
        BatchNorm statistics); None means every row is real."""
        (abs_xyz, rel_xyz, _, scales3, onehots, proj_uv,
         z_pts) = self._point_features(pts9, proj_tlp, style_lut)
        out = self._apply_model(self.models[name], proj_uv, rel_xyz,
                                onehots, z_pts, proj_hf, proj_seg, pts_mask)
        return helpers.get_gaussian_points(abs_xyz, scales3, out)[0]

    def raster_view(self, gs_pts: torch.Tensor, cam_pos: torch.Tensor,
                    cam_quat: torch.Tensor) -> torch.Tensor:
        """Rasterize + flips -> [H, W, 3]."""
        cam = self.camera.params_f32(cam_pos, cam_quat)
        out = rasterize_points14(gs_pts, cam, self.cfg.rasterizer)
        self.last_render = out
        img = out.image.flip(-1)  # flip_lr (upstream default)
        if self.ds.flip_ud:
            img = img.flip(-2)
        return img.permute(1, 2, 0)

    @staticmethod
    def road_blur(img: torch.Tensor, road_mask: torch.Tensor
                  ) -> torch.Tensor:
        """Gaussian-blur composite over road pixels (kernel 3, sigma 2)."""
        rm = road_mask[..., None].to(img.dtype)
        return _gaussian_blur3(img, sigma=2.0) * rm + img * (1 - rm)

    # ------------------------------------------------------------------
    # frames
    # ------------------------------------------------------------------

    def render_pose(self, points_all: np.ndarray, centers, proj_hf,
                    proj_seg, style_lut, pose: dict
                    ) -> Tuple[torch.Tensor, int]:
        """One frame: returns (float frame [H, W, 3] in [-1, 1] before the
        uint8 cast, visible points fed to the generators)."""
        cam_pos = np.array([pose["tx"], pose["ty"], pose["tz"]], np.float32)
        cam_quat = np.array([pose["qx"], pose["qy"], pose["qz"],
                             pose["qw"]], np.float32)
        t = self._now()
        vis_pts, road = self.visible_points(points_all, cam_pos, cam_quat)
        t = self._record("raycast", t)
        pts9 = self.normalize_points(vis_pts, centers)
        parts = []
        if self.class_budgets:
            masks = self.host_class_split(pts9)
            for name in self.models:
                budget = self.class_budgets.get(name, self.max_points)
                rows, n_drop = select_nearest_rows(
                    pts9[masks[name]], cam_pos, budget)
                if n_drop:
                    logging.warning(
                        "frame %s: %s bucket over budget, dropped %d "
                        "farthest of %d points", pose["id"], name, n_drop,
                        n_drop + budget)
                parts.append((name, rows))
        else:
            rows, n_drop = select_nearest_rows(pts9, cam_pos,
                                               self.max_points)
            if n_drop:
                logging.warning(
                    "frame %s: point budget exceeded, dropped %d farthest "
                    "of %d points", pose["id"], n_drop, len(pts9))
            parts.append((None, rows))
        dev_parts = [(name, torch.as_tensor(rows, dtype=torch.float32,
                                            device=self.device))
                     for name, rows in parts]
        n = int(sum(len(rows) for _, rows in parts))
        t = self._record("points", t)
        t_gen, gs = t, []
        for name, p in dev_parts:
            if name is None:
                gs.append(self.predict_attrs(p, proj_hf, proj_seg, None,
                                             style_lut))
                continue
            gs.append(self.predict_attrs_single(name, p, proj_hf, proj_seg,
                                                None, style_lut))
            t = self._record(f"generator_{name}", t)
        gs = torch.cat(gs)
        t = self._record("generator", t_gen)
        f32 = dict(dtype=torch.float32, device=self.device)
        img = self.raster_view(gs, torch.as_tensor(cam_pos, **f32),
                               torch.as_tensor(cam_quat, **f32))
        t = self._record("rasterize", t)
        img = self.road_blur(img, road)
        self._record("blur", t)
        out = self.last_render
        self.frame_stats.append({
            "n_visible": n,
            **{f"n_{name}": len(rows) for name, rows in parts if name},
            "n_dropped_pairs": int(out.n_dropped_pairs),
            "n_truncated": int(out.n_truncated),
            "n_grad_truncated": int(out.n_grad_truncated)})
        return img, n

    def prepare(self, projections, centers, style_lut=None, water_z=0):
        """Per-trajectory set-up: points, volume, projection maps and the
        style table on the device."""
        z_dim = self.cfg.network.z_dim or 1
        if style_lut is None:
            style_lut = get_style_lut(centers, z_dim)
        t = self._now()
        points_all = self.build_points(projections, water_z)
        t = self._record("extrude", t)
        self.build_volume(points_all)
        self._record("volume", t)
        logging.info("extruded %d points", len(points_all))
        f32 = dict(dtype=torch.float32, device=self.device)
        proj_hf = torch.as_tensor(
            np.asarray(projections["REST"]["TD_HF"], np.float32),
            **f32)[..., None]
        seg = np.asarray(projections["REST"]["SEG"])
        proj_seg = torch.as_tensor(np.stack(
            [(seg == i) for i in range(self.ds.n_classes)], -1
        ).astype(np.float32), **f32)
        return (points_all, proj_hf, proj_seg,
                torch.as_tensor(np.asarray(style_lut, np.float32), **f32))

    @torch.inference_mode()
    def render_trajectory(self, projections, centers,
                          camera_poses: List[dict],
                          style_lut: Optional[np.ndarray] = None,
                          water_z: int = 0,
                          video_path: Optional[str] = None,
                          fps: int = 4) -> List[np.ndarray]:
        """Render every pose; returns uint8 [H, W, 3] frames and writes a
        video when ``video_path`` is given."""
        points_all, proj_hf, proj_seg, lut = self.prepare(
            projections, centers, style_lut, water_z)
        frames = []
        for pose in camera_poses:
            img, n = self.render_pose(points_all, centers, proj_hf,
                                      proj_seg, lut, pose)
            t = self._now()
            frames.append(frame_to_uint8(img))
            self._record("readback", t)
            logging.info("frame %s: %d visible points", pose["id"], n)
        if video_path:
            write_video(video_path, frames, fps)
        return frames
