# -*- coding: utf-8 -*-
"""Host-side (numpy) data transforms (counterpart of
``gaussiancity_tpu/data/transforms.py``; upstream utils/transforms.py).

The upstream pipeline (RandomCrop, rejection-sampled on mask pixels and on
the visible-point budget; RandomInstance; RemoveUnseenPoints;
NormalizePointCords; ToOneHot), then ``PadPoints`` (the point list padded
to ``max_points`` with a validity mask) and ``ToBatchArrays`` (the NHWC
batch dict of ``training.step``).  Every transform makes the same
``np.random.Generator`` calls in the same order as the JAX package's, so
one seed gives one batch in both packages."""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np


class Compose:
    def __init__(self, transforms: List[Any]):
        self.transforms = transforms

    def __call__(self, data, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        for tr in self.transforms:
            data = tr(data, rng)
        return data


class RandomCrop:
    """(upstream utils/transforms.py:55-137)"""

    def __init__(self, height, width, mode="random", n_min_pixels=0,
                 n_min_points=0, n_max_points=0,
                 objects=("rgb", "seg", "ins", "vpm", "msk")):
        self.height = height
        self.width = width
        self.mode = mode
        self.n_min_pixels = n_min_pixels
        self.n_min_points = n_min_points
        self.n_max_points = n_max_points
        self.objects = objects

    def _offset(self, size, crop, rng):
        if size == crop:
            return 0
        if self.mode == "random":
            return int(rng.integers(0, size - crop - 1))
        if self.mode == "center":
            return size // 2 - crop // 2
        raise ValueError(self.mode)

    def __call__(self, data, rng):
        h, w = data["msk"].shape[:2]
        for _ in range(100):
            ox = self._offset(w, self.width, rng)
            oy = self._offset(h, self.height, rng)
            mask = data["msk"][oy: oy + self.height, ox: ox + self.width]
            vpm = data["vpm"][oy: oy + self.height, ox: ox + self.width]
            if np.count_nonzero(mask) < self.n_min_pixels:
                continue
            if self.n_max_points == 0 and self.n_min_points == 0:
                break
            n_points = len(np.unique(vpm))
            if ((self.n_min_points == 0 or n_points >= self.n_min_points)
                    and (self.n_max_points == 0
                         or n_points <= self.n_max_points)):
                break
        data["crp"] = {"x": ox, "y": oy, "w": self.width, "h": self.height}
        for k in self.objects:
            if k in data:
                data[k] = data[k][oy: oy + self.height, ox: ox + self.width]
        data["msk"] = mask
        data["vpm"] = vpm
        return data


class RandomInstance:
    """Keep ``n_instances`` random visible instances in ``range`` (all of
    them at 0) and mask the rest (upstream utils/transforms.py:140-172)."""

    def __init__(self, n_instances=None, range=None):
        self.n_instances = n_instances
        self.range = range

    def __call__(self, data, rng):
        if self.n_instances is None:
            return data
        ins_map = data["ins"] * data["msk"]
        visible = np.unique(ins_map[ins_map > 0])
        if self.range is not None:
            visible = visible[(visible >= self.range[0])
                              & (visible < self.range[1])]
        if len(visible) == 0:
            data["msk"] = np.zeros_like(data["msk"])
            return data
        ins = (rng.choice(visible, self.n_instances, replace=False)
               if self.n_instances > 0 else visible)
        data["msk"] = data["msk"] & np.isin(data["ins"], ins)
        data["vpm"] = np.where(data["msk"], data["vpm"], -1)
        return data


class RemoveUnseenPoints:
    """(upstream utils/transforms.py:175-183)"""

    def __call__(self, data, rng):
        vpm = data["vpm"]
        data["pts"] = data["pts"][np.unique(vpm[vpm != -1])]
        return data


def _normalize_rel_cords(pts: np.ndarray, centers) -> np.ndarray:
    """Per-instance normalized coordinates.  pts [N, >=5] with the
    instance id in column 4; centers maps id -> (cx, cy, w, h, d).
    Returns [N, 4]: rel_xyz + dense batch index."""
    ids = pts[:, 4].astype(np.int64)
    uniq, inv = np.unique(ids, return_inverse=True)
    ctr = np.array([centers.get(int(u), (0.0, 0.0, 0.0, 0.0, 0.0))
                    if hasattr(centers, "get") else centers[int(u)]
                    for u in uniq], dtype=np.float32).reshape(-1, 5)
    c = ctr[inv]  # [N, 5] -> cx, cy, w, h, d
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


class NormalizePointCords:
    """Per-instance relative xyz from the instance centres, and the dense
    batch index (upstream utils/transforms.py:186-206), vectorised."""

    def __call__(self, data, rng):
        pts = data["pts"]
        rel_bidx = _normalize_rel_cords(pts, data["centers"])
        data["pts"] = np.concatenate([pts.astype(np.float32), rel_bidx],
                                     axis=1)
        return data


class ToOneHot:
    """(upstream utils/transforms.py:209-235)"""

    def __init__(self, n_classes, objects=("seg", "proj/seg"),
                 ignored_classes=()):
        self.n_classes = n_classes
        self.objects = objects
        self.ignored = set(ignored_classes)

    def __call__(self, data, rng):
        for k in self.objects:
            if k not in data:
                continue
            mask = data[k]
            data[k] = np.stack([(mask == i).astype(np.uint8)
                                for i in range(self.n_classes)
                                if i not in self.ignored], axis=-1)
        return data


class PadPoints:
    """Pad the [N, 9] points to ``max_points`` rows (a random sorted
    subset where there are more) with a bool validity mask."""

    def __init__(self, max_points: int):
        self.max_points = max_points

    def __call__(self, data, rng):
        pts = data["pts"]
        n = len(pts)
        if n > self.max_points:
            keep = rng.choice(n, self.max_points, replace=False)
            keep.sort()
            pts = pts[keep]
            n = self.max_points
        out = np.zeros((self.max_points, pts.shape[1]), dtype=np.float32)
        out[:n] = pts
        data["pts"] = out
        data["pts_mask"] = np.arange(self.max_points) < n
        return data


class ToBatchArrays:
    """The NHWC arrays of one item of the train step's batch."""

    def __call__(self, data, rng):
        out = {
            "pts": data["pts"].astype(np.float32),
            "pts_mask": data["pts_mask"],
            "rgb": data["rgb"].astype(np.float32),
            "seg": data["seg"].astype(np.float32),
            "msk": data["msk"].astype(np.float32)[..., None],
            "cam_pos": data["cam_pos"].astype(np.float32),
            "cam_quat": data["cam_quat"].astype(np.float32),
            "crp_xy": np.array([data["crp"]["x"], data["crp"]["y"]],
                               dtype=np.int32),
        }
        if "proj/hf" in data:
            out["proj_hf"] = data["proj/hf"].astype(np.float32)[..., None]
        if "proj/seg" in data:
            out["proj_seg"] = data["proj/seg"].astype(np.float32)
        if "proj/tlp" in data:
            out["proj_tlp"] = np.asarray(data["proj/tlp"], np.float32)
        return out


def train_pipeline(ds_cfg, max_points: int) -> Compose:
    """(upstream utils/datasets.py:146-199)"""
    return Compose([
        RandomCrop(height=ds_cfg.train_crop_size[1],
                   width=ds_cfg.train_crop_size[0],
                   n_min_pixels=ds_cfg.train_min_pixels,
                   n_max_points=ds_cfg.train_max_points),
        RandomInstance(ds_cfg.train_n_instances, ds_cfg.train_instance_range),
        RemoveUnseenPoints(),
        NormalizePointCords(),
        ToOneHot(ds_cfg.n_classes),
        PadPoints(max_points),
        ToBatchArrays(),
    ])


def test_pipeline(ds_cfg, max_points: int) -> Compose:
    """(upstream utils/datasets.py:200-253)"""
    return Compose([
        RandomCrop(height=ds_cfg.test_crop_size[1],
                   width=ds_cfg.test_crop_size[0], mode="center"),
        RandomInstance(ds_cfg.test_n_instances, ds_cfg.test_instance_range),
        RemoveUnseenPoints(),
        NormalizePointCords(),
        ToOneHot(ds_cfg.n_classes),
        PadPoints(max_points),
        ToBatchArrays(),
    ])
