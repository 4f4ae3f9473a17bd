"""The reference frame: a frozen plain copy of the port's inference
pipeline (``inference/pipeline.py``) on the reference's own extrusion,
id volume, raycast, generators and rasterizer, with no stage timing.

``ReferencePipeline.render_pose`` returns what the benchmark compares: the
visible point rows, the Gaussians fed to the rasterizer and the uint8
frame.  The pose, weight and city helpers are copies of the pipeline's
and of the data layer's (``_normalize_rel_cords``,
``instances_to_classes_np``)."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gcbench.reference.gct.camera import CameraModel, matrix_to_quat_xyzw
from gcbench.reference.gct.ops import extrusion as ext
from gcbench.reference.gct.ops import visibility as vis
from gcbench.reference.gct.ops.rasterizer import rasterize_points14
from gcbench.reference.gct.utils import helpers


def get_quat_from_look_at(cam_pos, look_at):
    """Roll-free (z-up) orientation looking from ``cam_pos`` at
    ``look_at``, as an (x, y, z, w) quaternion; columns [F|R|U]."""
    f = np.subtract(look_at, cam_pos).astype(np.float64)
    f /= np.linalg.norm(f)
    r = np.cross([0.0, 0.0, 1.0], f)
    r /= np.linalg.norm(r)
    return matrix_to_quat_xyzw(np.column_stack([f, r, np.cross(f, r)]))


def get_orbit_camera_poses(proj_size: int, n_points: int, radius: float,
                           altitude: float):
    """Orbit of ``n_points`` poses around the map centre."""
    c = proj_size // 2
    poses = []
    for i in range(n_points):
        theta = 2 * math.pi / n_points * i
        cam_x = c + radius * math.cos(theta)
        cam_y = c + radius * math.sin(theta)
        quat = get_quat_from_look_at(np.array([cam_x, cam_y, altitude]),
                                     np.array([c, c, 1.0]))
        poses.append({"id": i, "tx": cam_x, "ty": cam_y, "tz": altitude,
                      "qx": quat[0], "qy": quat[1], "qz": quat[2],
                      "qw": quat[3]})
    return poses


def get_style_lut(z_dim: int, seed: int,
                  max_instances: int = helpers.MAX_N_INSTANCES
                  ) -> np.ndarray:
    """Per-instance style table [max_instances, z_dim], U[0, 1)."""
    rng = np.random.default_rng(seed)
    return rng.random((max_instances, z_dim)).astype(np.float32)


def normalize_rel_cords(pts: np.ndarray, centers) -> np.ndarray:
    """Per-instance normalized coordinates + dense batch index [N, 4]."""
    ids = pts[:, 4].astype(np.int64)
    uniq, inv = np.unique(ids, return_inverse=True)
    ctr = np.array([centers.get(int(u), (0.0, 0.0, 0.0, 0.0, 0.0))
                    for u in uniq], dtype=np.float32).reshape(-1, 5)
    c = ctr[inv]
    x = pts[:, 0].astype(np.float32)
    y = pts[:, 1].astype(np.float32)
    z = pts[:, 2].astype(np.float32)
    rel = np.zeros((len(pts), 3), np.float32)
    w, h, d = c[:, 2], c[:, 3], c[:, 4]
    rel[:, 0] = np.where(w > 0, (x - c[:, 0]) / np.maximum(w, 1e-9) * 2, 0)
    rel[:, 1] = np.where(h > 0, (y - c[:, 1]) / np.maximum(h, 1e-9) * 2, 0)
    rel[:, 2] = np.where(d > 0,
                         np.clip(z / np.maximum(d, 1e-9) * 2 - 1, -1, 1), 0)
    return np.concatenate([rel, inv.astype(np.float32)[:, None]], axis=1)


def instances_to_classes_np(instances: np.ndarray, ds) -> np.ndarray:
    inst = instances.astype(np.int64)
    out = inst.copy()
    in_bldg = (inst >= ds.bldg_range[0]) & (inst < ds.bldg_range[1])
    out[in_bldg & (inst % 2 == 0)] = ds.bldg_facade_clsid
    out[in_bldg & (inst % 2 == 1)] = ds.bldg_roof_clsid
    if ds.car_range is not None:
        in_car = (inst >= ds.car_range[0]) & (inst < ds.car_range[1])
        out[in_car] = ds.car_clsid
    return out


def class_scales(ds):
    """The extrusion's scale of each class, by the dataset's name (the
    pipeline's ``dataset_generator.class_scale_table``)."""
    return (ext.KITTI_360_CLASS_SCALES if ds.name == "KITTI_360"
            else ext.GOOGLE_EARTH_CLASS_SCALES)


def select_nearest_rows(pts9: np.ndarray, cam_pos: np.ndarray,
                        budget: int):
    n = len(pts9)
    if n <= budget:
        return pts9
    d2 = np.sum(
        (pts9[:, :3] - np.asarray(cam_pos, np.float32)[None]) ** 2, 1)
    return pts9[np.sort(np.argpartition(d2, budget - 1)[:budget])]


def gaussian_blur3(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    x = np.arange(-1, 2, dtype=np.float32)
    k1 = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k1 /= k1.sum()
    C = img.shape[-1]
    k = torch.as_tensor(np.outer(k1, k1), device=img.device)
    padded = F.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="reflect")
    out = F.conv2d(padded, k.expand(C, 1, 3, 3), groups=C)
    return out[0].permute(1, 2, 0)


def frame_to_uint8(img: torch.Tensor) -> np.ndarray:
    return (torch.clamp(img / 2 + 0.5, 0, 1) * 255).to(
        torch.uint8).cpu().numpy()


class ReferencePipeline:
    """The per-frame path of ``InferencePipeline`` in plain PyTorch:
    ``models`` maps "REST" / "BLDG" / "CAR" to reference generators;
    ``class_budgets`` selects the compact per-class path."""

    def __init__(self, cfg, models: Dict[str, torch.nn.Module],
                 max_points: int, vol_shape: Tuple[int, int, int],
                 class_budgets: Optional[Dict[str, int]], device):
        self.cfg = cfg
        self.ds = cfg.dataset
        self.models = {n: m.eval() for n, m in models.items()}
        self.max_points = max_points
        self.vol_shape = tuple(vol_shape)
        self.class_budgets = class_budgets
        self.device = torch.device(device)
        self.camera = CameraModel(np.asarray(self.ds.cam_k).reshape(3, 3),
                                  self.ds.sensor_size)

    def prepare(self, projections, centers, style_lut: np.ndarray,
                water_z: int = 0):
        ds = self.ds
        self.centers = centers
        rel = ext.SegInsRelation(
            bldg_ins_min_id=ds.bldg_range[0],
            bldg_facade_semantic_id=ds.bldg_facade_clsid,
            bldg_roof_semantic_id=ds.bldg_roof_clsid,
            car_ins_min_id=ds.car_range[0] if ds.car_range else 32767,
            car_semantic_id=ds.car_clsid if ds.car_clsid else 32767)
        dev = self.device
        all_pts = []
        for c, p in projections.items():
            maps = [torch.as_tensor(np.asarray(p[k], np.int32), device=dev)
                    for k in ("INS", "TD_HF", "BU_HF")]
            maps.append(torch.as_tensor(np.asarray(p["PTS"]) != 0,
                                        device=dev))
            pts = ext.extrude_points_exact(*maps, rel, class_scales(ds),
                                           include_btm_pts=(c != "REST"))
            if c == "REST":
                pts[pts[:, 4] == 5, 2] = water_z
            all_pts.append(pts)
        points = torch.cat(all_pts).cpu().numpy()
        h, w, d = self.vol_shape
        pts = torch.as_tensor(points, device=dev)
        scales3 = helpers.get_point_scales(
            pts[:, 3:4].float(), pts[:, 4]).to(torch.int32)
        mins = points[:, :3].min(0)
        self._offsets = torch.as_tensor(
            np.array([mins[0], mins[1], mins[2] - 1], np.int32), device=dev)
        ids = torch.arange(1, len(points) + 1, dtype=torch.int32, device=dev)
        self._vol = vis.points_to_volume(pts[:, :3] - self._offsets, ids,
                                         scales3, h, w, d)
        self._pts_dev = pts
        f32 = dict(dtype=torch.float32, device=dev)
        self._proj_hf = torch.as_tensor(
            np.asarray(projections["REST"]["TD_HF"], np.float32),
            **f32)[..., None]
        seg = np.asarray(projections["REST"]["SEG"])
        self._proj_seg = torch.as_tensor(np.stack(
            [(seg == i) for i in range(ds.n_classes)], -1
        ).astype(np.float32), **f32)
        self._lut = torch.as_tensor(style_lut, **f32)
        self.points = points

    def visible_points(self, cam_pos, cam_quat):
        W, H = self.ds.sensor_size
        K = np.asarray(self.ds.cam_k).reshape(3, 3)
        f32 = dict(dtype=torch.float32, device=self.device)
        vp_map, ins_map = vis.visible_from_volume(
            self._vol, self._pts_dev, torch.as_tensor(cam_pos, **f32),
            torch.as_tensor(cam_quat, **f32), cam_f=float(K[0, 0]),
            cam_c=(float(K[1, 2]), float(K[0, 2])), img_dims=(H, W),
            offsets=self._offsets)
        vp_idx = torch.unique(vp_map[vp_map >= 0]).cpu().numpy()
        return self.points[vp_idx], ins_map == 1

    def _features(self, pts9: torch.Tensor):
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
        proj_uv = helpers.get_projection_uv(abs_xyz, None, ds.proj_size)
        lut = self._lut
        z_pts = lut[(instances[0] % lut.shape[0]).long()][None]
        return abs_xyz, rel_xyz, classes, scales3, onehots, proj_uv, z_pts

    def _apply(self, module, proj_uv, rel_xyz, onehots, z_pts):
        z_in = z_pts if module.cfg.z_dim is not None else None
        mask = torch.ones(rel_xyz.shape[:2], dtype=torch.bool,
                          device=rel_xyz.device)
        return module(proj_uv, rel_xyz, None, onehots, z_in,
                      self._proj_hf[None], self._proj_seg[None], mask)

    def _class_masks(self, classes: torch.Tensor):
        ds = self.ds
        bldg = torch.zeros_like(classes, dtype=torch.bool)
        car = torch.zeros_like(classes, dtype=torch.bool)
        if "BLDG" in self.models:
            bldg = torch.isin(classes, torch.tensor(
                [ds.bldg_facade_clsid, ds.bldg_roof_clsid],
                device=classes.device))
        if "CAR" in self.models and ds.car_clsid is not None:
            car = classes == ds.car_clsid
        return {"BLDG": bldg, "CAR": car, "REST": ~(bldg | car)}

    def _host_class_split(self, pts9: np.ndarray):
        ds = self.ds
        classes = instances_to_classes_np(pts9[:, 4].astype(np.int64), ds)
        bldg = np.zeros(len(pts9), bool)
        car = np.zeros(len(pts9), bool)
        if "BLDG" in self.models:
            bldg = np.isin(classes, [ds.bldg_facade_clsid,
                                     ds.bldg_roof_clsid])
        if "CAR" in self.models and ds.car_clsid is not None:
            car = classes == ds.car_clsid
        return {"BLDG": bldg, "CAR": car, "REST": ~(bldg | car)}

    @torch.no_grad()
    def render_pose(self, pose: dict):
        """(visible rows [M, 5], Gaussians [n, 14], uint8 frame)."""
        ds = self.ds
        cam_pos = np.array([pose["tx"], pose["ty"], pose["tz"]], np.float32)
        cam_quat = np.array([pose["qx"], pose["qy"], pose["qz"],
                             pose["qw"]], np.float32)
        vis_pts, road = self.visible_points(cam_pos, cam_quat)
        pts9 = np.concatenate([vis_pts.astype(np.float32),
                               normalize_rel_cords(vis_pts, self.centers)],
                              axis=1)
        gs = []
        f32 = dict(dtype=torch.float32, device=self.device)
        if self.class_budgets:
            masks = self._host_class_split(pts9)
            for name, module in self.models.items():
                rows = select_nearest_rows(
                    pts9[masks[name]], cam_pos,
                    self.class_budgets.get(name, self.max_points))
                p = torch.as_tensor(rows, **f32)
                abs_xyz, rel_xyz, _, scales3, onehots, uv, z = \
                    self._features(p)
                out = self._apply(module, uv, rel_xyz, onehots, z)
                gs.append(helpers.get_gaussian_points(abs_xyz, scales3,
                                                      out)[0])
        else:
            rows = select_nearest_rows(pts9, cam_pos, self.max_points)
            p = torch.as_tensor(rows, **f32)
            abs_xyz, rel_xyz, classes, scales3, onehots, uv, z = \
                self._features(p)
            masks = self._class_masks(classes[0])
            attrs = {}
            for name, module in self.models.items():
                out = self._apply(module, uv, rel_xyz, onehots, z)
                m = masks[name][None, :, None]
                for k, v in out.items():
                    prev = attrs.get(k)
                    attrs[k] = torch.where(
                        m, v, prev if prev is not None
                        else torch.zeros_like(v))
            gs.append(helpers.get_gaussian_points(abs_xyz, scales3,
                                                  attrs)[0])
        gs = torch.cat(gs)
        cam = self.camera.params_f32(torch.as_tensor(cam_pos, **f32),
                                     torch.as_tensor(cam_quat, **f32))
        img = rasterize_points14(gs, cam, self.cfg.rasterizer).image.flip(-1)
        if ds.flip_ud:
            img = img.flip(-2)
        img = img.permute(1, 2, 0)
        rm = road[..., None].to(img.dtype)
        img = gaussian_blur3(img, sigma=2.0) * rm + img * (1 - rm)
        return vis_pts, gs, frame_to_uint8(img)
