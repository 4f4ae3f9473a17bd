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

BLOCK_VOXELS = 1 << 21  # (pixel, z) rows extruded at once


class SegInsRelation(NamedTuple):
    """(reference: scripts/dataset_generator.py:984-1005)"""

    bldg_ins_min_id: int = 100
    roof_ins_offset: int = 1
    bldg_facade_semantic_id: int = 2
    bldg_roof_semantic_id: int = 7
    car_ins_min_id: int = 32767
    car_semantic_id: int = 32767


def extrude_points_np(
    ins_map: np.ndarray, td_hf: np.ndarray, bu_hf: np.ndarray,
    pts_map: np.ndarray, rel: SegInsRelation,
    class_scales: Sequence[int], include_btm_pts: bool = True,
) -> np.ndarray:
    """NumPy mirror of footprint_extruder.cpp (offline host path), every
    column's voxels at once.  Returns [N, 5] int32 (x, y, z, scale,
    instance)."""
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

    # one row per (pixel, z) of every masked column, pixels row-major and
    # z ascending: z runs over range(bu, td + 1, s); the columns go in
    # blocks that start within one BLOCK_VOXELS window of rows, so the rows
    # held before the border test stay bounded on a large map
    ii, jj = np.nonzero(pts_map)
    s, b, t = scale[ii, jj], bu[ii, jj], td[ii, jj]
    n = np.maximum((t - b) // s + 1, 0)
    first = np.cumsum(n) - n
    blocks = []
    for cols in np.split(np.arange(len(ii)), np.flatnonzero(
            np.diff(first // BLOCK_VOXELS)) + 1):
        nc = n[cols]
        col = np.repeat(cols, nc)
        k = b[col] + s[col] * (np.arange(len(col))
                               - np.repeat(np.cumsum(nc) - nc, nc))
        i, j, sc, tc = ii[col], jj[col], s[col], t[col]
        is_top = k > tc - sc
        at_edge = (j < sc) | (j >= W - sc - 1) | (i < sc) | (i >= H - sc - 1)
        keep = is_top | at_edge | ~nbs[i, j]
        if include_btm_pts:
            keep |= k == b[col]
        roof = is_top & (sem[i, j] == rel.bldg_facade_semantic_id)
        out_id = ins[i, j] + np.where(roof, rel.roof_ins_offset, 0)
        blocks.append(np.stack([j, i, k, sc, out_id], axis=1)[keep])
    return np.concatenate(blocks).astype(np.int32)
