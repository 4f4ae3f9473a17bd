# -*- coding: utf-8 -*-
"""BEV footprint extrusion: projection maps -> shell voxel points
(counterpart of ``gaussiancity_tpu/ops/extrusion.py``; upstream
footprint_extruder.cpp:100-222 and voxlib maps_to_volume.cu).

Semantics:
  - emit only where the PTS mask is set
  - semantic id: < BLDG_INS_MIN_ID -> itself; >= CAR_INS_MIN_ID -> CAR;
    else BLDG_FACADE; ids at or above the scale table's length (the car
    sentinel) take the table's last entry
  - per-pixel z walk k = BU, BU+s, ..., <= TD (s = the pixel's scale)
  - border test: top of column (z > TD - s), bottom (z == BU, when
    include_btm_pts), map edge, or any 8-neighbour at stride s differing
    in INS or TD
  - roof recovery: top-of-column facade voxels get instance += 1
  - point order: row-major pixels, ascending z

The forms:

- ``extrude_dense`` (torch ops on any device): the JAX package's dense
  [H, W, D] emit mask and per-voxel instance ids.
- ``extrude_points``: the JAX package's padded list [n_max, 5] of the
  voxels below ``d_max``, with its validity mask and overflow count.
- ``extrude_points_exact``: every voxel, unpadded, no z cap; the
  dataset path's form, equal to ``extrude_points_np``.
- ``extrude_points_np``: the NumPy mirror (host).

Both tensor forms go through ``extrude_rows``, which in this reference
copy runs ``extrude_rows_plain`` (the NumPy mirror's vectorised walk in
torch, in blocks of columns) on any device (the port launches kernel E1
there).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


BLOCK_VOXELS = 1 << 21  # (pixel, z) rows extruded at once
# kernel E1's tiling (csrc/extrude.cu: TILE, GROUP, MAX_SCALES)
E1_TILE = 1024  # pixels a block
E1_GROUP = 64  # tiles a group total
E1_MAX_SCALES = 16  # class scale table entries, passed by value


class SegInsRelation(NamedTuple):
    """(reference: scripts/dataset_generator.py:984-1005)"""

    bldg_ins_min_id: int = 100
    roof_ins_offset: int = 1
    bldg_facade_semantic_id: int = 2
    bldg_roof_semantic_id: int = 7
    car_ins_min_id: int = 32767
    car_semantic_id: int = 32767


# class id -> extrusion scale (upstream dataset_generator.py:68-87; index =
# class id of its CLASSES table :42-66)
GOOGLE_EARTH_CLASS_SCALES = (1, 2, 1, 2, 1, 4, 2, 1)  # NULL..BLDG_ROOF
KITTI_360_CLASS_SCALES = (1, 2, 1, 1, 1, 4, 2, 1)


def semantic_ids(instance: torch.Tensor, rel: SegInsRelation
                 ) -> torch.Tensor:
    return torch.where(
        instance >= rel.car_ins_min_id,
        torch.full_like(instance, rel.car_semantic_id),
        torch.where(instance >= rel.bldg_ins_min_id,
                    torch.full_like(instance, rel.bldg_facade_semantic_id),
                    instance))


def _pixel_scales(ins: torch.Tensor, rel: SegInsRelation,
                  class_scales: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(semantic ids, scale) per pixel; semantic ids outside the table
    clamp into it."""
    sem = semantic_ids(ins, rel)
    table = torch.as_tensor(class_scales, dtype=torch.int32,
                            device=ins.device)
    return sem, table[sem.clamp(0, len(class_scales) - 1).long()]


def _neighbor_same(m: torch.Tensor, s: int) -> torch.Tensor:
    """True where all 8 neighbours at stride s equal the centre, the map
    edge-padded (``np.pad(mode="edge")``)."""
    H, W = m.shape
    dev = m.device
    same = torch.ones((H, W), dtype=torch.bool, device=dev)
    for dy in (-s, 0, s):
        rows = (torch.arange(H, device=dev) + dy).clamp(0, H - 1)
        for dx in (-s, 0, s):
            if dy == 0 and dx == 0:
                continue
            cols = (torch.arange(W, device=dev) + dx).clamp(0, W - 1)
            same &= m[rows][:, cols] == m
    return same


def _border_columns(ins: torch.Tensor, td: torch.Tensor, scale: torch.Tensor,
                    class_scales: Sequence[int]) -> torch.Tensor:
    """True where the whole column is shell: the map edge (``j < s``,
    ``j >= W - s - 1``, likewise for i) or an 8-neighbour at the pixel's
    stride s that differs in INS or TD."""
    H, W = ins.shape
    dev = ins.device
    nb_same = torch.ones((H, W), dtype=torch.bool, device=dev)
    for s in sorted(set(int(v) for v in class_scales)):
        same_s = _neighbor_same(ins, s) & _neighbor_same(td, s)
        nb_same = torch.where(scale == s, same_s, nb_same)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    at_edge = ((xx < scale) | (xx >= W - scale - 1) | (yy < scale)
               | (yy >= H - scale - 1))
    return at_edge | ~nb_same


def extrude_dense(ins_map: torch.Tensor, td_hf: torch.Tensor,
                  bu_hf: torch.Tensor, pts_map: torch.Tensor,
                  rel: SegInsRelation, class_scales: Sequence[int],
                  d_max: int, include_btm_pts: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense extrusion over z in [0, d_max): (emit [H, W, D] bool,
    voxel instance [H, W, D] int32 with the roof offset on top facade
    voxels)."""
    ins = ins_map.int()
    td, bu = td_hf.int(), bu_hf.int()
    sem, scale = _pixel_scales(ins, rel, class_scales)
    ks = torch.arange(d_max, dtype=torch.int32, device=ins.device)
    ks = ks[None, None, :]
    b, t, s3 = bu[..., None], td[..., None], scale[..., None]
    on_walk = (ks >= b) & (ks <= t) & (torch.remainder(ks - b, s3) == 0)
    is_top = ks > t - s3
    border = is_top | _border_columns(ins, td, scale, class_scales)[..., None]
    if include_btm_pts:
        border = border | (ks == b)
    emit = pts_map.bool()[..., None] & on_walk & border
    roof = is_top & (sem == rel.bldg_facade_semantic_id)[..., None]
    vox_ins = torch.where(roof, ins[..., None] + rel.roof_ins_offset,
                          ins[..., None])
    return emit, vox_ins.expand(emit.shape).int()


def extrude_rows_plain(ins_map: torch.Tensor, td_hf: torch.Tensor,
                       bu_hf: torch.Tensor, pts_map: torch.Tensor,
                       rel: SegInsRelation, class_scales: Sequence[int],
                       include_btm_pts: bool = True,
                       z_cap: Optional[int] = None,
                       capacity: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E1's plain version: the NumPy mirror's walk in torch.  Returns
    (rows, n): the rows (x, y, z, scale, instance) int32 in row-major
    pixel and ascending z order, and n, the number of voxels (0-dim
    int64).  With ``z_cap`` only voxels with 0 <= z < z_cap count; with
    ``capacity`` the rows are [capacity, 5], the first min(n, capacity)
    filled and the rest 0."""
    H, W = ins_map.shape
    dev = ins_map.device
    ins, td, bu = ins_map.int(), td_hf.int(), bu_hf.int()
    sem, scale = _pixel_scales(ins, rel, class_scales)
    border = _border_columns(ins, td, scale, class_scales)
    ii, jj = torch.nonzero(pts_map.bool(), as_tuple=True)
    s, b, t = scale[ii, jj], bu[ii, jj], td[ii, jj]
    n = (torch.div(t - b, s, rounding_mode="floor") + 1).clamp(min=0).long()
    first = torch.cumsum(n, 0) - n
    # columns in blocks that start within one BLOCK_VOXELS window of rows
    _, sizes = torch.unique_consecutive(
        torch.div(first, BLOCK_VOXELS, rounding_mode="floor"),
        return_counts=True)
    blocks = []
    for cols in torch.arange(len(ii), device=dev).split(sizes.tolist()):
        nc = n[cols]
        col = torch.repeat_interleave(cols, nc)
        step = (torch.arange(len(col), device=dev)
                - torch.repeat_interleave(torch.cumsum(nc, 0) - nc, nc))
        k = b[col] + s[col] * step.int()
        i, j, sc, tc = ii[col], jj[col], s[col], t[col]
        is_top = k > tc - sc
        keep = is_top | border[i, j]
        if include_btm_pts:
            keep |= k == b[col]
        if z_cap is not None:
            keep &= (k >= 0) & (k < z_cap)
        roof = is_top & (sem[i, j] == rel.bldg_facade_semantic_id)
        out_id = ins[i, j] + torch.where(roof, rel.roof_ins_offset, 0)
        blocks.append(torch.stack([j.int(), i.int(), k, sc, out_id.int()],
                                  1)[keep])
    rows = (torch.cat(blocks) if blocks
            else torch.zeros((0, 5), dtype=torch.int32, device=dev))
    total = torch.tensor(len(rows), dtype=torch.int64, device=dev)
    if capacity is not None:
        out = torch.zeros((capacity, 5), dtype=torch.int32, device=dev)
        m = min(len(rows), capacity)
        out[:m] = rows[:m]
        rows = out
    return rows, total


def _check_maps(maps) -> None:
    shape, dev = maps[0].shape, maps[0].device
    if len(shape) != 2:
        raise ValueError(f"maps must be [H, W], got {tuple(shape)}")
    for m in maps:
        if m.shape != shape or m.device != dev:
            raise ValueError("INS, TD_HF, BU_HF and PTS must share shape "
                             "and device")


def extrude_rows(ins_map: torch.Tensor, td_hf: torch.Tensor,
                 bu_hf: torch.Tensor, pts_map: torch.Tensor,
                 rel: SegInsRelation, class_scales: Sequence[int],
                 include_btm_pts: bool = True, z_cap: Optional[int] = None,
                 capacity: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The extruded voxels by ``extrude_rows_plain`` on any device."""
    maps = (ins_map, td_hf, bu_hf, pts_map)
    _check_maps(maps)
    return extrude_rows_plain(*maps, rel, class_scales, include_btm_pts,
                              z_cap, capacity)



def extrude_points(ins_map: torch.Tensor, td_hf: torch.Tensor,
                   bu_hf: torch.Tensor, pts_map: torch.Tensor,
                   rel: SegInsRelation, class_scales: Sequence[int],
                   d_max: int, n_max: int, include_btm_pts: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX ``extrude_points``: the voxels below ``d_max`` as a padded
    list [n_max, 5] int32 (x, y, z, scale, instance), its validity mask
    [n_max] and the overflow count (0-dim int32)."""
    out, n = extrude_rows(ins_map, td_hf, bu_hf, pts_map, rel, class_scales,
                          include_btm_pts, z_cap=d_max, capacity=n_max)
    valid = torch.arange(n_max, device=out.device) < n.clamp(max=n_max)
    return out, valid, (n - n_max).clamp(min=0).int()


def extrude_points_exact(ins_map: torch.Tensor, td_hf: torch.Tensor,
                         bu_hf: torch.Tensor, pts_map: torch.Tensor,
                         rel: SegInsRelation, class_scales: Sequence[int],
                         include_btm_pts: bool = True) -> torch.Tensor:
    """Every voxel, no z cap: [N, 5] int32 equal to ``extrude_points_np``
    on the same maps."""
    return extrude_rows(ins_map, td_hf, bu_hf, pts_map, rel, class_scales,
                        include_btm_pts)[0]


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
