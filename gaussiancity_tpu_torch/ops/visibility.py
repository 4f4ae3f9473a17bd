# -*- coding: utf-8 -*-
"""Voxel visibility: point scatter to an id volume and a first-hit DDA
raycast (counterpart of ``gaussiancity_tpu/ops/visibility.py``; upstream
voxlib points_to_volume.cu and ray_voxel_intersection.cu).

``raycast`` launches kernel V1 (``csrc/raycast.cu``, one thread per ray,
testing cells against the bit-packed ``pack_occupancy`` tables) on CUDA
tensors and runs ``raycast_plain`` (lockstep over the live rays, testing
the id volume) on CPU tensors.  Both follow the plain cell-by-cell DDA of
the JAX package's ``ray_voxel_intersection``:

- ray basis by Gram-Schmidt from the view direction and world up, with
  ``ndc = (cy - py, px - cx)`` and dir = up*ndc0 + side*ndc1 + fwd*f;
- rays starting above the highest occupied layer (``ztop``) skip
  analytically to ``ztop + 0.5`` (upward rays miss), re-basing the origin
  there so first hits round as in the JAX march; depths are measured
  from the true origin;
- the origin cell is never tested; each later cell is tested on entry
  and its entry parameter is the hit depth.

``pack_occupancy`` builds the JAX package's tables (per-column z-words
and their OR over 4x4 and 16x16 column blocks), once per volume; V1 tests
each entered cell against them, jumps over empty regions of them to the
state the cell-by-cell walk would reach, and reads the id volume only at
the hit.  The JAX march's banding, column stepping and survivor
compaction are not carried over: V1's hits and depths are those of
``raycast_plain`` bit for bit.  Volumes are indexed [y, x, z] and ray
origins given in that order.

``get_visible_points`` is dataset generation's view: the id volume of the
view's points, then the raycast, as ``visible_from_volume``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gaussiancity_tpu_torch import _kernels
from gaussiancity_tpu_torch.camera import quat_xyzw_to_matrix


def points_to_volume(points: torch.Tensor, pt_ids: torch.Tensor,
                     scales: torch.Tensor, h: int, w: int, d: int,
                     max_scale: int = 4, valid=None) -> torch.Tensor:
    """Id volume [h, w, d] int32 (layout [y, x, z]); each point fills its
    scale box [x, x+s) x [y, y+s) x [z, z+sz).  Overlaps combine by max.
    Points whose (s, sz) is not one of the groups (s in 1..max_scale,
    sz in {1, s}) are left out, as in the JAX version."""
    N = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=dev)
    pts = points.long()
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    in_range = (valid & (x >= 0) & (x < w) & (y >= 0) & (y < h)
                & (z >= 0) & (z < d))
    lin = ((y.clamp(0, h - 1) * w + x.clamp(0, w - 1)) * d
           + z.clamp(0, d - 1))
    ids = pt_ids.to(torch.int32)
    vol = torch.zeros((h, w, d), dtype=torch.int32, device=dev)
    groups = [(s, sz) for s in range(1, max_scale + 1)
              for sz in sorted({1, s})]
    for s, sz in groups:
        m = in_range & (scales[:, 0] == s) & (scales[:, 2] == sz)
        if not bool(m.any()):
            continue
        base = torch.zeros(h * w * d, dtype=torch.int32, device=dev)
        base.scatter_reduce_(0, lin[m], ids[m], reduce="amax")
        base = base.view(h, w, d)
        # max over the window [i - ext + 1, i] along each axis
        for axis, ext in ((0, s), (1, s), (2, sz)):
            src = base
            base = base.clone()
            for k in range(1, ext):
                n = base.shape[axis]
                if k >= n:
                    break
                dst = base.narrow(axis, k, n - k)
                torch.maximum(dst, src.narrow(axis, 0, n - k), out=dst)
        vol = torch.maximum(vol, base)
    return vol


# xy edge of a coarse column block: the tables cover 1, 4 and 16 columns
COARSE = 4


class Occupancy(NamedTuple):
    """Bit-packed occupancy of an id volume [h, w, d] (the JAX package's
    ``pack_occupancy``): ``occ_words`` [h, w, ceil(d/32)] uint32 holds bit
    z % 32 of word z // 32 per column; ``coarse_cols`` [ceil(h/4),
    ceil(w/4), ceil(d/32)] is the OR of each 4x4 block of columns and
    ``coarse2_cols`` the OR of each 4x4 block of those, both at full z
    resolution; ``ztop`` is 1 + the highest occupied z (0 if empty)."""
    occ_words: torch.Tensor
    ztop: float
    coarse_cols: torch.Tensor
    coarse2_cols: torch.Tensor


def _block_or(words: torch.Tensor) -> torch.Tensor:
    """[h, w, dw] int32 -> [ceil(h/C), ceil(w/C), dw]: the OR of each
    C x C block (C = COARSE), zero-padded at the ragged edge."""
    h, w, dw = words.shape
    hb, wb = -(-h // COARSE), -(-w // COARSE)
    padded = words.new_zeros((hb * COARSE, wb * COARSE, dw))
    padded[:h, :w] = words
    blocks = padded.reshape(hb, COARSE, wb, COARSE, dw)
    out = blocks[:, 0, :, 0].clone()
    for i in range(COARSE):
        for j in range(COARSE):
            if i or j:
                out |= blocks[:, i, :, j]
    return out


def pack_occupancy(volume: torch.Tensor) -> Occupancy:
    """The occupancy tables of ``volume`` [h, w, d] (0 = empty), built with
    torch ops on the volume's device.  Built once per volume: the
    inference pipeline caches them next to the id volume."""
    h, w, d = volume.shape
    occ = volume != 0
    dw = -(-d // 32)
    if dw * 32 > d:
        occ = torch.cat([occ, occ.new_zeros((h, w, dw * 32 - d))], dim=2)
    bits = occ.reshape(h, w, dw, 32)
    words = torch.zeros((h, w, dw), dtype=torch.int32, device=volume.device)
    for b in range(32):
        words |= bits[..., b].to(torch.int32) << b
    coarse = _block_or(words)
    coarse2 = _block_or(coarse)
    nz = torch.nonzero(occ.any(dim=0).any(dim=0))
    ztop = float(nz.max()) + 1.0 if nz.numel() else 0.0
    return Occupancy(words.view(torch.uint32), ztop,
                     coarse.view(torch.uint32), coarse2.view(torch.uint32))


def _norm3(v):
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def ray_basis(cam_ori: torch.Tensor, cam_dir: torch.Tensor,
              cam_up: torch.Tensor) -> torch.Tensor:
    """[12] float32: origin, up, side, fwd (volume axis order)."""
    cam_dir, cam_up = cam_dir.float(), cam_up.float()
    fwd = cam_dir / _norm3(cam_dir)
    side = _cross(fwd, cam_up)
    side = side / _norm3(side)
    up = _cross(side, fwd)
    up = up / _norm3(up)
    return torch.cat([cam_ori.float(), up, side, fwd]).contiguous()


def ray_directions(rays: torch.Tensor, cam_f: float,
                   cam_c: Tuple[float, float], img_dims: Tuple[int, int]
                   ) -> torch.Tensor:
    """[H, W, 3] float32 unit direction of each pixel's ray (volume axis
    order), from the ``ray_basis`` ``rays``: up * (cy - py) + side *
    (px - cx) + fwd * f, normalised.  V1 computes the same per ray."""
    H, W = img_dims
    f32 = dict(dtype=torch.float32, device=rays.device)
    ndc0 = cam_c[0] - torch.arange(H, **f32)[:, None]
    ndc1 = torch.arange(W, **f32)[None, :] - cam_c[1]
    up, side, fwd = rays[3:6], rays[6:9], rays[9:12]
    rd = [up[i] * ndc0 + side[i] * ndc1 + fwd[i] * cam_f for i in range(3)]
    nrm = torch.sqrt(rd[0] * rd[0] + rd[1] * rd[1] + rd[2] * rd[2])
    return torch.stack([r / nrm for r in rd], dim=-1)


def raycast_plain(volume: torch.Tensor, rays: torch.Tensor, cam_f: float,
                  cam_c: Tuple[float, float], img_dims: Tuple[int, int],
                  ztop: float):
    """Plain PyTorch version of V1: every live ray takes one DDA step per
    iteration, and finished rays drop out.

    Returns (voxel_id [H, W] int32 (0 = miss), depth [H, W] float32
    (inf on a miss), n_steps [H, W] int32 cells each ray crossed,
    n_cells: the number of distinct in-volume cells the rays read)."""
    H, W = img_dims
    dev = volume.device
    dims = torch.tensor(volume.shape, device=dev)
    h, w, d = volume.shape
    vol_flat = volume.reshape(-1)
    f32 = dict(dtype=torch.float32, device=dev)
    o = rays[0:3]
    rd = ray_directions(rays, cam_f, cam_c, img_dims).reshape(-1, 3)
    R = H * W

    z_land = torch.tensor(ztop + 0.5, **f32)
    above = o[2] > z_land
    t_skip = torch.where(above & (rd[:, 2] < 0), (z_land - o[2]) / rd[:, 2],
                         torch.zeros_like(rd[:, 2]))
    t_skip = torch.clamp(t_skip, min=0.0)
    miss0 = above & (rd[:, 2] >= 0)
    org = o[None, :] + t_skip[:, None] * rd  # re-based origins [R, 3]

    voxel_id = torch.zeros(R, dtype=torch.int32, device=dev)
    depth = torch.full((R,), float("inf"), **f32)
    n_steps = torch.zeros(R, dtype=torch.int32, device=dev)

    ray = torch.nonzero(~miss0)[:, 0]
    org, rd, t_skip = org[ray], rd[ray], t_skip[ray]
    cell = torch.floor(org).long()
    s01 = (rd > 0).long()
    step = torch.where(rd > 0, 1, -1)
    inv = 1.0 / rd
    inf = torch.full_like(rd, float("inf"))
    tmax = torch.where(rd == 0, inf, ((cell + s01).float() - org) * inv)
    steps = torch.zeros_like(ray, dtype=torch.int32)
    read = torch.zeros(h * w * d, dtype=torch.uint8, device=dev)
    while ray.numel():
        L = ray.numel()
        ar = torch.arange(L, device=dev)
        axis = torch.argmin(tmax, dim=1)  # first minimum on ties
        t = tmax[ar, axis]
        st = step[ar, axis]
        ca = cell[ar, axis] + st
        cell[ar, axis] = ca
        away = ((st > 0) & (ca >= dims[axis])) | ((st < 0) & (ca < 0))
        tmax[ar, axis] = (((ca + s01[ar, axis]).float() - org[ar, axis])
                          * inv[ar, axis])
        inside = ((cell >= 0) & (cell < dims)).all(dim=1)
        lin = (cell[:, 0] * w + cell[:, 1]) * d + cell[:, 2]
        lin = torch.where(inside, lin, 0)
        v = torch.where(inside, vol_flat[lin], 0)
        read.scatter_reduce_(0, lin, inside.to(torch.uint8), "amax")
        hit = inside & (v != 0)
        steps += 1
        fin = hit | away
        voxel_id[ray[hit]] = v[hit]
        depth[ray[hit]] = t[hit] + t_skip[hit]
        n_steps[ray[fin]] = steps[fin]
        keep = ~fin
        ray, org, rd, t_skip = ray[keep], org[keep], rd[keep], t_skip[keep]
        cell, s01, step, inv = cell[keep], s01[keep], step[keep], inv[keep]
        tmax, steps = tmax[keep], steps[keep]
    return (voxel_id.reshape(H, W), depth.reshape(H, W),
            n_steps.reshape(H, W), read.sum())


def _check_occupancy(volume: torch.Tensor, occupancy: Occupancy) -> None:
    h, w, d = volume.shape
    dw = -(-d // 32)
    hb, wb = -(-h // COARSE), -(-w // COARSE)
    want = {"occ_words": (h, w, dw), "coarse_cols": (hb, wb, dw),
            "coarse2_cols": (-(-hb // COARSE), -(-wb // COARSE), dw)}
    for name, shape in want.items():
        t = getattr(occupancy, name)
        if t.dtype != torch.uint32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a uint32 {shape} tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != volume.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on the volume's "
                             "device")


def _check_raycast(volume: torch.Tensor, rays: torch.Tensor) -> None:
    if volume.dtype != torch.int32 or volume.dim() != 3:
        raise TypeError("volume must be an int32 [h, w, d] tensor")
    if rays.dtype != torch.float32 or tuple(rays.shape) != (12,):
        raise TypeError("rays must be a float32 [12] tensor")
    if rays.device != volume.device:
        raise ValueError("rays and volume must be on one device")
    if not (volume.is_contiguous() and rays.is_contiguous()):
        raise ValueError("volume and rays must be contiguous")
    if volume.numel() >= 2 ** 31:
        raise ValueError("volume too large for 32-bit voxel ids")


def _launch_raycast(volume, rays, cam_f, cam_c, img_dims, occupancy,
                    work=None):
    """Kernel V1 on CUDA tensors; ``work`` (int32 [H, W, 2] or None)
    selects the variant that counts steps and jumps."""
    H, W = img_dims
    h, w, d = volume.shape
    dev = volume.device
    voxel_id = torch.empty((H, W), dtype=torch.int32, device=dev)
    depth = torch.empty((H, W), dtype=torch.float32, device=dev)
    tile_counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    _kernels.launch(
        "raycast", volume.data_ptr(), occupancy.occ_words.data_ptr(),
        occupancy.coarse_cols.data_ptr(), occupancy.coarse2_cols.data_ptr(),
        h, w, d, rays.data_ptr(), H, W, float(cam_c[0]), float(cam_c[1]),
        float(cam_f), float(occupancy.ztop), voxel_id.data_ptr(),
        depth.data_ptr(), tile_counter.data_ptr(),
        0 if work is None else work.data_ptr(), _kernels.stream_handle(dev))
    return voxel_id, depth


def raycast(volume: torch.Tensor, rays: torch.Tensor, cam_f: float,
            cam_c: Tuple[float, float], img_dims: Tuple[int, int],
            occupancy: Optional[Occupancy] = None):
    """First-hit raycast of an H x W image through ``volume`` [h, w, d]
    int32 (0 = empty) with ``rays`` from ``ray_basis``.  Returns
    (voxel_id [H, W] int32, depth [H, W] float32).

    ``occupancy`` is ``pack_occupancy(volume)``: pass it where the volume
    outlives the call, or it is built here (as in the JAX package); its
    ``ztop`` sets the sky skip.  CUDA tensors go to kernel V1, which tests
    cells against its tables; CPU tensors to the plain version."""
    _check_raycast(volume, rays)
    if occupancy is None:
        occupancy = pack_occupancy(volume)
    _check_occupancy(volume, occupancy)
    if not volume.is_cuda:
        return raycast_plain(volume, rays, cam_f, cam_c, img_dims,
                             occupancy.ztop)[:2]
    return _launch_raycast(volume, rays, cam_f, cam_c, img_dims, occupancy)


def raycast_work(volume: torch.Tensor, rays: torch.Tensor, cam_f: float,
                 cam_c: Tuple[float, float], img_dims: Tuple[int, int],
                 occupancy: Occupancy):
    """``raycast`` and the work it did: (voxel_id, depth, work [H, W, 2]
    int32), work holding per ray the cells stepped and the empty regions
    jumped.  A measurement of V1's design (the plain version steps every
    cell and jumps none); frames call ``raycast``."""
    _check_raycast(volume, rays)
    _check_occupancy(volume, occupancy)
    H, W = img_dims
    work = torch.zeros((H, W, 2), dtype=torch.int32, device=volume.device)
    if not volume.is_cuda:
        voxel_id, depth, work[..., 0], _ = raycast_plain(
            volume, rays, cam_f, cam_c, img_dims, occupancy.ztop)
        return voxel_id, depth, work
    return _launch_raycast(volume, rays, cam_f, cam_c, img_dims, occupancy,
                           work) + (work,)


class RaycastResult(NamedTuple):
    voxel_id: torch.Tensor  # [H, W] int32 value stored in the volume
    depth: torch.Tensor  # [H, W] float32 entry parameter; inf on a miss
    raydirs: torch.Tensor  # [H, W, 3] float32 unit ray directions


def ray_voxel_intersection(volume: torch.Tensor, cam_ori: torch.Tensor,
                           cam_dir: torch.Tensor, cam_up: torch.Tensor,
                           cam_f: float, cam_c: Tuple[float, float],
                           img_dims: Tuple[int, int],
                           occupancy: Optional[Occupancy] = None
                           ) -> RaycastResult:
    """First-hit raycast with the camera given in volume coordinates
    (y, x, z); the JAX package's function of the same name, which also
    takes a prebuilt ``pack_occupancy(volume)``."""
    rays = ray_basis(torch.as_tensor(cam_ori, device=volume.device),
                     torch.as_tensor(cam_dir, device=volume.device),
                     torch.as_tensor(cam_up, device=volume.device))
    return RaycastResult(*raycast(volume, rays, cam_f, cam_c, img_dims,
                                  occupancy),
                         ray_directions(rays, cam_f, cam_c, img_dims))


def world_ray_basis(cam_pos: torch.Tensor, cam_quat: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """``ray_basis`` of a world pose (position, xyzw quaternion looking
    along its rotation's first column) in a volume whose origin lies at
    world ``offsets``."""
    cam_pos_loc = cam_pos.float() - offsets.float()
    look = quat_xyzw_to_matrix(cam_quat.float())[:, 0]
    # the volume is indexed [y, x, z]: swap x / y of origin and direction
    ori = torch.stack([cam_pos_loc[1], cam_pos_loc[0], cam_pos_loc[2]])
    vdir = torch.stack([look[1], look[0], look[2]])
    up = torch.tensor([0.0, 0.0, 1.0], device=cam_pos.device)
    return ray_basis(ori, vdir, up)


def visible_from_volume(vol: torch.Tensor, points: torch.Tensor,
                        cam_pos: torch.Tensor, cam_quat: torch.Tensor,
                        cam_f: float, cam_c: Tuple[float, float],
                        img_dims: Tuple[int, int], offsets: torch.Tensor,
                        occupancy: Optional[Occupancy] = None):
    """Raycast a prebuilt id volume (1-based point ids) from a world pose,
    with its ``pack_occupancy`` tables where the caller keeps them.
    Returns (vp_map [H, W] point index or -1, ins_map [H, W])."""
    voxel_id, _ = raycast(vol, world_ray_basis(cam_pos, cam_quat, offsets),
                          cam_f, cam_c, img_dims, occupancy)
    vp_map = voxel_id.long() - 1
    ins = points[:, 4]
    ins_map = torch.where(vp_map >= 0, ins[vp_map.clamp(min=0)],
                          torch.zeros_like(vp_map, dtype=ins.dtype))
    return vp_map, ins_map


def get_visible_points(points: torch.Tensor, scales3: torch.Tensor,
                       cam_pos: torch.Tensor, cam_quat: torch.Tensor,
                       cam_f: float, cam_c: Tuple[float, float],
                       img_dims: Tuple[int, int],
                       vol_shape: Tuple[int, int, int],
                       offsets: torch.Tensor, valid=None):
    """Visible points of one view (upstream dataset_generator.py
    :1420-1461): the id volume of ``points`` [N, 5] (x, y, z, scale,
    instance) at 1-based point ids, its origin at world ``offsets``
    (x, y, z), then ``visible_from_volume``.  Returns (vp_map [H, W] point
    index or -1, ins_map [H, W])."""
    h, w, d = vol_shape
    ids = torch.arange(1, points.shape[0] + 1, dtype=torch.int32,
                       device=points.device)
    vol = points_to_volume(points[:, :3] - offsets, ids, scales3, h, w, d,
                           valid=valid)
    return visible_from_volume(vol, points, cam_pos, cam_quat, cam_f, cam_c,
                               img_dims, offsets)
