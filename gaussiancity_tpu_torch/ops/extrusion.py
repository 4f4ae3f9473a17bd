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

Both tensor forms go through ``extrude_rows``, which launches kernel E1
(``csrc/extrude.cu``: a count pass and an emit pass over tiles of
pixels) on CUDA tensors and runs ``extrude_rows_plain`` (the NumPy
mirror's vectorised walk in torch, in blocks of columns) on CPU tensors.
``extrude_rows_by_rank`` repeats E1's indexing in torch for the tests.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gaussiancity_tpu_torch import _kernels

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


def extrude_rows_by_rank(ins_map: torch.Tensor, td_hf: torch.Tensor,
                         bu_hf: torch.Tensor, pts_map: torch.Tensor,
                         rel: SegInsRelation, class_scales: Sequence[int],
                         include_btm_pts: bool = True,
                         z_cap: Optional[int] = None,
                         capacity: Optional[int] = None,
                         tile: int = E1_TILE, group: int = E1_GROUP
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E1's indexing in torch, for the tests: what ``extrude_rows_plain``
    returns, built as the kernel builds it.  Each column's rows are one
    run (count, first z, z step, the top's z) in closed form; the tiles
    of ``tile`` row-major pixels start at the sum of the totals of the
    groups (``group`` tiles) before theirs and of the tiles before them
    in their group; a tile's row of rank r takes the last pixel whose
    first row is at or before r and z = first z + its rank in the column
    times the step."""
    H, W = ins_map.shape
    dev = ins_map.device
    ins, td, bu = ins_map.int(), td_hf.int(), bu_hf.int()
    sem, s = _pixel_scales(ins, rel, class_scales)
    border = _border_columns(ins, td, s, class_scales)
    n = (torch.div(td - bu, s, rounding_mode="floor") + 1).clamp(min=0)
    klast = bu + (n - 1) * s

    def under_cap(k):
        return (torch.ones_like(k, dtype=torch.bool) if z_cap is None
                else (k >= 0) & (k < z_cap))

    if z_cap is None:
        q_lo, q_hi = torch.zeros_like(n), n
    else:
        q_lo = torch.where(bu < 0, torch.div(-bu + s - 1, s,
                                             rounding_mode="floor"), 0)
        q_hi = torch.where(bu >= z_cap, 0, torch.minimum(
            n, torch.div(z_cap - bu + s - 1, s, rounding_mode="floor")))
    with_btm = (n > 1) & under_cap(bu) & include_btm_pts
    cnt = torch.where(border, (q_hi - q_lo).clamp(min=0),
                      with_btm.int() + under_cap(klast).int())
    cnt = torch.where(pts_map.bool() & (n > 0), cnt, 0).flatten().long()
    k0 = torch.where(border, bu + q_lo * s,
                     torch.where(with_btm, bu, klast)).flatten()
    dk = torch.where(border, s, klast - bu).flatten()
    n_tiles = -(-H * W // tile)
    n_groups = -(-n_tiles // group)
    counts = torch.nn.functional.pad(cnt, (0, n_tiles * tile - H * W))
    counts = counts.view(n_tiles, tile)
    tile_total = counts.sum(1)
    by_group = torch.nn.functional.pad(
        tile_total, (0, n_groups * group - n_tiles)).view(n_groups, group)
    group_total = by_group.sum(1)
    total = int(group_total.sum())
    tile_first = ((torch.cumsum(group_total, 0) - group_total)
                  .repeat_interleave(group)
                  + (torch.cumsum(by_group, 1) - by_group).flatten()
                  )[:n_tiles]
    first_row = torch.cumsum(counts, 1) - counts  # in-tile exclusive scan
    end = total if capacity is None else min(total, capacity)
    blocks = []
    for t in range(n_tiles):
        lo = int(tile_first[t])
        hi = min(lo + int(tile_total[t]), end)
        if lo >= hi:
            continue
        rank = torch.arange(hi - lo, device=dev)
        p = torch.searchsorted(first_row[t], rank, right=True) - 1
        g = t * tile + p
        k = k0[g] + (rank - first_row[t][p]).int() * dk[g]
        i, j = g // W, g % W
        top = k == klast.flatten()[g]
        roof = top & (sem.flatten()[g] == rel.bldg_facade_semantic_id)
        out_id = ins.flatten()[g] + torch.where(roof, rel.roof_ins_offset, 0)
        blocks.append(torch.stack([j.int(), i.int(), k.int(),
                                   s.flatten()[g], out_id.int()], 1))
    rows = (torch.cat(blocks) if blocks
            else torch.zeros((0, 5), dtype=torch.int32, device=dev))
    if capacity is not None:
        rows = torch.cat([rows, torch.zeros((capacity - len(rows), 5),
                                            dtype=torch.int32, device=dev)])
    return rows, torch.tensor(total, dtype=torch.int64, device=dev)


def _check_maps(maps) -> None:
    shape, dev = maps[0].shape, maps[0].device
    if len(shape) != 2:
        raise ValueError(f"maps must be [H, W], got {tuple(shape)}")
    for m in maps:
        if m.shape != shape or m.device != dev:
            raise ValueError("INS, TD_HF, BU_HF and PTS must share shape "
                             "and device")


def e1_launch_args(ins_map: torch.Tensor, td_hf: torch.Tensor,
                   bu_hf: torch.Tensor, pts_map: torch.Tensor,
                   rel: SegInsRelation, class_scales: Sequence[int],
                   include_btm_pts: bool = True, z_cap: Optional[int] = None
                   ) -> Tuple[tuple, tuple]:
    """E1's launcher arguments for CUDA maps up to the output pointer
    (``_kernels.launch("extrude", *args, out, cap, stream)``: pass A with
    a null ``out``, pass B with the rows), and the tensors they point
    into, to keep alive until both are queued; the last is the sums
    (``sums[0]`` the row count after pass A).  INS, TD_HF and BU_HF go as
    int16 when all three are (the PNG maps), else as int32, and a bool or
    uint8 PTS as it is; other types are converted first.  The scale table
    goes by value in the kernels' parameters."""
    if not 1 <= len(class_scales) <= E1_MAX_SCALES:
        raise ValueError(f"E1 takes 1-{E1_MAX_SCALES} class scales, got "
                         f"{len(class_scales)}")
    if min(class_scales) < 1:
        raise ValueError("class scales must be >= 1")
    maps = (ins_map, td_hf, bu_hf, pts_map)
    map_type = (torch.int16 if all(m.dtype == torch.int16 for m in maps[:3])
                else torch.int32)
    ins, td, bu = (m.to(map_type).contiguous() for m in maps[:3])
    pts = (pts_map if pts_map.dtype in (torch.bool, torch.uint8)
           else pts_map != 0).contiguous()
    H, W = ins.shape
    n_tiles = -(-H * W // E1_TILE)
    sums = torch.empty((1 + -(-n_tiles // E1_GROUP) + n_tiles,),
                       dtype=torch.int64, device=ins.device)
    scales = (ctypes.c_int * len(class_scales))(*class_scales)
    args = (ins.data_ptr(), td.data_ptr(), bu.data_ptr(), pts.data_ptr(),
            ins.element_size(), H, W, scales, len(class_scales),
            rel.bldg_ins_min_id, rel.car_ins_min_id,
            rel.bldg_facade_semantic_id, rel.car_semantic_id,
            rel.roof_ins_offset, int(include_btm_pts),
            -1 if z_cap is None else int(z_cap), sums.data_ptr(),
            sums.numel())
    return args, (ins, td, bu, pts, scales, sums)


def extrude_rows(ins_map: torch.Tensor, td_hf: torch.Tensor,
                 bu_hf: torch.Tensor, pts_map: torch.Tensor,
                 rel: SegInsRelation, class_scales: Sequence[int],
                 include_btm_pts: bool = True, z_cap: Optional[int] = None,
                 capacity: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The extruded voxels as ``extrude_rows_plain`` returns them.  CUDA
    maps go to kernel E1 (``csrc/extrude.cu``, arguments from
    ``e1_launch_args``): pass A counts the rows of each tile of pixels and
    their total, pass B writes each tile's rows from its first one.
    Without ``capacity`` the output is sized by the total, read into
    pinned memory with one wait on the host; with it nothing waits (pass
    B writes the zero padding too): two counts of ``extrude`` in
    ``_kernels.launches``.  CPU maps go to the plain version."""
    maps = (ins_map, td_hf, bu_hf, pts_map)
    _check_maps(maps)
    if not ins_map.is_cuda:
        return extrude_rows_plain(*maps, rel, class_scales, include_btm_pts,
                                  z_cap, capacity)
    if capacity is not None and capacity < 0:
        raise ValueError("capacity must be >= 0")
    dev = ins_map.device
    args, keep = e1_launch_args(*maps, rel, class_scales, include_btm_pts,
                                z_cap)
    total = keep[-1][0]
    if ins_map.numel() == 0:
        total.zero_()
        return torch.zeros((capacity or 0, 5), dtype=torch.int32,
                           device=dev), total
    stream = _kernels.stream_handle(dev)
    _kernels.launch("extrude", *args, None, 0, stream)
    n_out = capacity
    if n_out is None:
        host = torch.empty((), dtype=torch.int64, pin_memory=True)
        host.copy_(total, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()
        n_out = int(host)
    out = torch.empty((n_out, 5), dtype=torch.int32, device=dev)
    if n_out:
        _kernels.launch("extrude", *args, out.data_ptr(), n_out, stream)
    return out, total


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
