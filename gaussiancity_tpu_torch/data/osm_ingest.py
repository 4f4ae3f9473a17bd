# -*- coding: utf-8 -*-
"""Raw-capture ingestion: OSM renders + Google Earth projects ->
projection maps (counterpart of ``gaussiancity_tpu/data/osm_ingest.py``;
reference: scripts/dataset_generator.py:189-379).

Consumes the artifacts the published pipeline provides per city:

- ``osm_dir/<city>/hf.png``      top-down height field (uint16)
- ``osm_dir/<city>/seg.png``     semantic map (palette png)
- ``osm_dir/<city>/metadata.json``  georeference {resolution, bounds}
- ``city_dir/<project>.esp``     Google Earth Studio project (camera target)
- ``city_dir/metadata.json``     capture metadata {clat, elevation}

and produces the ``{"REST": {INS, SEG, TD_HF, BU_HF, PTS}}`` projection
dict + metadata that ``generate_city`` / the inference pipeline consume.

Reimplemented in this repo's idiom: connected components via
scipy.ndimage, the point-stride mask as one vectorized modulo test, the
.esp attribute tree walked by a generic finder, and the cross-city
building-instance registry as an explicit object instead of function
statics.  KITTI-360's ingestion (3D-bbox annotations -> surface
voxelization, reference :389-440) lives in ``data/kitti_ingest.py``
with an own SAT voxelizer replacing open3d.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from gaussiancity_tpu_torch.data.dataset_generator import (
    CLASSES, CONSTANTS, SCALES,
)
from gaussiancity_tpu_torch.data.camera_recovery import lnglat_to_web_mercator_xy


def build_instance_map(seg_map: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Building footprints -> per-building instance ids
    (reference: :326-343, from CityDreamer).

    4-connected components of the BLDG_FACADE mask become even instance
    ids starting at ``2 * (BLDG_INST_RANGE[0] + 1)`` (facade 2k, roof
    2k+1); all other classes keep their semantic id.  Returns
    (instance map int32, component centroid/extent stats [K, 4]).
    """
    from scipy import ndimage

    cls = CLASSES["GOOGLE_EARTH"]
    bldg = seg_map == cls["BLDG_FACADE"]
    # 4-connectivity structure (no diagonals), matching cv2 connectivity=4
    labels, n = ndimage.label(bldg, structure=[[0, 1, 0],
                                               [1, 1, 1],
                                               [0, 1, 0]])
    ins = np.where(bldg,
                   (labels + CONSTANTS["GOOGLE_EARTH"]["BLDG_INST_RANGE"][0])
                   * 2,
                   seg_map).astype(np.int32)
    # bbox stats per component (x, y, w, h) like connectedComponentsWithStats
    stats = np.zeros((n + 1, 4), np.int64)
    if n:
        ys, xs = np.nonzero(bldg)
        lb = labels[ys, xs]
        for k, (lo_f, hi_f) in enumerate(
                zip(ndimage.minimum(xs, lb, range(1, n + 1)),
                    ndimage.maximum(xs, lb, range(1, n + 1))), start=1):
            stats[k, 0] = lo_f
            stats[k, 2] = hi_f - lo_f + 1
        for k, (lo_f, hi_f) in enumerate(
                zip(ndimage.minimum(ys, lb, range(1, n + 1)),
                    ndimage.maximum(ys, lb, range(1, n + 1))), start=1):
            stats[k, 1] = lo_f
            stats[k, 3] = hi_f - lo_f + 1
    return ins, stats


def point_stride_mask(seg_map: np.ndarray, dataset: str = "GOOGLE_EARTH"
                      ) -> np.ndarray:
    """The PTS sampling mask: True on a per-class-stride lattice
    (reference: _get_point_maps/_get_point_map, :198-221).

    One vectorized modulo test over a per-pixel stride lookup replaces the
    per-class meshgrid loop.
    """
    cls = CLASSES[dataset]
    scl = SCALES[dataset]
    stride = np.ones(max(cls.values()) + 1, np.int32)
    keep = np.zeros(max(cls.values()) + 1, bool)
    for name, cid in cls.items():
        if name == "NULL":
            continue
        keep[cid] = True
        stride[cid] = scl.get(name, 1)
    seg = np.clip(seg_map, 0, len(stride) - 1)
    s = stride[seg]
    H, W = seg_map.shape
    ys = np.arange(H)[:, None]
    xs = np.arange(W)[None, :]
    return keep[seg] & (ys % s == 0) & (xs % s == 0)


def load_osm_city(osm_dir: str, city_name: str):
    """hf.png + seg.png + metadata.json -> (td_hf, seg, ins, metadata)
    (reference: _get_osm_data, :309-323)."""
    from PIL import Image

    d = os.path.join(osm_dir, city_name)
    td_hf = np.array(Image.open(os.path.join(d, "hf.png")))
    seg_img = Image.open(os.path.join(d, "seg.png"))
    # palettized/grayscale pngs already carry class indices; only convert
    # when the png has color channels (reference always converts to "P",
    # which is an identity on its palettized inputs)
    if seg_img.mode not in ("P", "L", "I", "I;16"):
        seg_img = seg_img.convert("P")
    seg = np.array(seg_img)
    cls = CLASSES["GOOGLE_EARTH"]
    seg[seg == cls["CONSTRUCTION"]] = cls["BLDG_FACADE"]
    with open(os.path.join(d, "metadata.json")) as fp:
        metadata = json.load(fp)
    ins, _ = build_instance_map(seg)
    return td_hf, seg, ins, metadata


def _find_attr(attributes, attr_type):
    """Find the first node with ``type == attr_type`` in a Google Earth
    Studio attribute list (each node: {"type", "attributes"| "value"})."""
    for node in attributes:
        if node.get("type") == attr_type:
            return node
    raise KeyError(f"attribute {attr_type!r} not found")


def get_camera_target(project_settings: dict, ge_metadata: dict) -> dict:
    """Scene camera target {longitude, latitude, altitude} from a .esp
    project tree (reference: _get_google_earth_camera_target, :347-378).

    latitudePOI's normalization is not invertible (reference note); the
    collected per-capture metadata supplies the latitude.
    """
    node = project_settings["scenes"][0]["attributes"]
    for t in ("cameraGroup", "cameraTargetEffect", "poi"):
        node = _find_attr(node, t)["attributes"]
    lng_poi = _find_attr(node, "longitudePOI")["value"]["relative"]
    alt_poi = _find_attr(node, "altitudePOI")["value"]["relative"]
    return {
        "longitude": lng_poi * 360.0 - 180.0,
        "latitude": ge_metadata["clat"],
        "altitude": alt_poi + 1.0,
    }


class BuildingInstanceRegistry:
    """Cross-capture stable building ids (reference keeps function statics
    ``instances``, :276-293): the same OSM building seen from a second
    capture keeps its id; new buildings get the next even id."""

    def __init__(self, start: Optional[int] = None):
        self.start = (CONSTANTS["GOOGLE_EARTH"]["BLDG_INST_RANGE"][0]
                      if start is None else start)
        self.mapping: Dict[int, int] = {}
        self._next = self.start

    def reassign(self, ins_map: np.ndarray) -> np.ndarray:
        lo = CONSTANTS["GOOGLE_EARTH"]["BLDG_INST_RANGE"][0]
        out = ins_map.copy()
        ids = np.unique(ins_map)
        # one lookup table covering every id in this crop
        lut_src = []
        lut_dst = []
        for ri in ids:
            ri = int(ri)
            if ri < lo:
                continue
            if ri not in self.mapping:
                self.mapping[ri] = self._next
                self._next += 2
            lut_src.append(ri)
            lut_dst.append(self.mapping[ri])
        if lut_src:
            src = np.asarray(lut_src)
            dst = np.asarray(lut_dst)
            pos = np.searchsorted(src, out)
            pos = np.clip(pos, 0, len(src) - 1)
            hit = src[pos] == out
            out = np.where(hit, dst[pos], out)
        return out


def google_earth_projections(city_dir: str, osm_dir: str,
                             registry: Optional[BuildingInstanceRegistry]
                             = None,
                             _cache: Dict[str, tuple] = {}):
    """Raw capture dir + OSM render dir -> (metadata, projections)
    (reference: _get_google_earth_projections, :224-306).

    The MAP_SIZE^2 window is centered on the capture's camera target in
    web-mercator map coordinates; building ids are re-assigned through the
    (optionally shared) registry; TD_HF gets the capture's elevation.
    """
    c = CONSTANTS["GOOGLE_EARTH"]
    city_name = "-".join(os.path.basename(
        os.path.normpath(city_dir)).split("-")[:2])
    if city_name not in _cache:
        td_hf, seg, ins, osm_meta = load_osm_city(osm_dir, city_name)
        pts = point_stride_mask(seg)
        _cache[city_name] = (td_hf, seg, ins, pts, osm_meta)
    td_hf, seg, ins, pts, osm_meta = _cache[city_name]

    project_name = os.path.basename(os.path.normpath(city_dir))
    with open(os.path.join(city_dir, f"{project_name}.esp")) as fp:
        project_settings = json.load(fp)
    with open(os.path.join(city_dir, "metadata.json")) as fp:
        ge_metadata = json.load(fp)

    target = get_camera_target(project_settings, ge_metadata)
    cx, cy = lnglat_to_web_mercator_xy(
        target["longitude"], target["latitude"], osm_meta["resolution"])
    cx = float(cx) - osm_meta["bounds"]["xmin"]
    cy = float(cy) - osm_meta["bounds"]["ymin"]
    half = c["MAP_SIZE"] // 2
    x0, x1 = int(cx - half), int(cx + half)
    y0, y1 = int(cy - half), int(cy + half)

    registry = registry or BuildingInstanceRegistry()
    reorg_ins = registry.reassign(ins[y0:y1, x0:x1])

    metadata = dict(osm_meta)
    metadata["target"] = {"x": cx, "y": cy, "z": target["altitude"]}
    return metadata, {
        "REST": {
            "PTS": pts[y0:y1, x0:x1],
            "INS": reorg_ins,
            "SEG": seg[y0:y1, x0:x1],
            "TD_HF": td_hf[y0:y1, x0:x1] + ge_metadata["elevation"],
            "BU_HF": np.zeros_like(td_hf[y0:y1, x0:x1]),
        }
    }
