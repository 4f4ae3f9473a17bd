# -*- coding: utf-8 -*-
"""BEV footprint extrusion on the host: projection maps -> shell voxel
points (counterpart of ``gaussiancity_tpu/ops/extrusion.py``'s NumPy path;
upstream footprint_extruder.cpp:100-222).

Semantics:
  - emit only where the PTS mask is set
  - semantic id: < BLDG_INS_MIN_ID -> itself; >= CAR_INS_MIN_ID -> CAR;
    else BLDG_FACADE
  - border test: top of column (z > TD - s), bottom (z == BU, when
    include_btm_pts), map edge, or any 8-neighbour at stride s differing
    in INS or TD
  - roof recovery: top-of-column facade voxels get instance += 1
  - point order: row-major pixels, ascending z
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class SegInsRelation(NamedTuple):
    """(reference: scripts/dataset_generator.py:984-1005)"""

    bldg_ins_min_id: int = 100
    roof_ins_offset: int = 1
    bldg_facade_semantic_id: int = 2
    bldg_roof_semantic_id: int = 7
    car_ins_min_id: int = 32767
    car_semantic_id: int = 32767


# class-id -> extrusion scale (reference: dataset_generator.py:68-87,
# GOOGLE_EARTH; index = class id per CLASSES table :42-66)
GOOGLE_EARTH_CLASS_SCALES = (1, 2, 1, 2, 1, 4, 2, 1)  # NULL..BLDG_ROOF
KITTI_360_CLASS_SCALES = (1, 2, 1, 1, 1, 4, 2, 1)


def extrude_points_np(
    ins_map: np.ndarray, td_hf: np.ndarray, bu_hf: np.ndarray,
    pts_map: np.ndarray, rel: SegInsRelation,
    class_scales: Sequence[int], include_btm_pts: bool = True,
) -> np.ndarray:
    """NumPy mirror of footprint_extruder.cpp (offline host path).
    Returns [N, 5] int arrays (x, y, z, scale, instance)."""
    H, W = ins_map.shape
    ins = ins_map.astype(np.int32)
    td = td_hf.astype(np.int32)
    bu = bu_hf.astype(np.int32)
    sem = np.where(
        ins >= rel.car_ins_min_id, rel.car_semantic_id,
        np.where(ins >= rel.bldg_ins_min_id, rel.bldg_facade_semantic_id, ins),
    )
    table = np.asarray(class_scales, dtype=np.int32)
    scale = table[np.clip(sem, 0, len(table) - 1)]

    def nb_same(m, s):
        pad = np.pad(m, s, mode="edge")
        same = np.ones((H, W), dtype=bool)
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                same &= pad[s + dy: s + dy + H, s + dx: s + dx + W] == m
        return same

    nbs = np.ones((H, W), dtype=bool)
    for s in sorted(set(int(v) for v in class_scales)):
        nbs_s = nb_same(ins, s) & nb_same(td, s)
        nbs = np.where(scale == s, nbs_s, nbs)

    pts = []
    for i in range(H):
        for j in range(W):
            if not pts_map[i, j]:
                continue
            s = int(scale[i, j])
            iid = int(ins[i, j])
            at_edge = j < s or j >= W - s - 1 or i < s or i >= H - s - 1
            for k in range(int(bu[i, j]), int(td[i, j]) + 1, s):
                is_top = k > td[i, j] - s
                is_btm = include_btm_pts and k == bu[i, j]
                if not (is_top or is_btm or at_edge or not nbs[i, j]):
                    continue
                out_id = iid
                if is_top and sem[i, j] == rel.bldg_facade_semantic_id:
                    out_id += rel.roof_ins_offset
                pts.append((j, i, k, s, out_id))
    return np.asarray(pts, dtype=np.int32).reshape(-1, 5)
