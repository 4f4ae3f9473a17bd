# -*- coding: utf-8 -*-
"""Multiresolution hash-grid positional encoding (counterpart of
``gaussiancity_tpu/ops/hash_grid.py``; upstream grid_encoder,
grid_encoder_ext.cu:51-249).

The table is ``[L, R_max, C]``, one padded row block per level with
level-local row indices, exactly as in the JAX package, so parameters
convert one to one.  Semantics:

- inputs in [-bound, bound] map to [0, 1]; out-of-bound points give 0;
- level scale ``2^(l * log2(s)) * base - 1``, resolution ceil(scale) + 1;
- dense indexing while the level's corner lattice fits its table, else
  the XOR-prime hash (uint32 arithmetic, emulated in int64 with a
  ``& 0xFFFFFFFF`` after each multiply);
- align_corners=False: pos = x * scale + 0.5;
- the gradient follows the JAX package's custom VJP (``_HashEncode``).

The forward is kernel G1 (``csrc/hash_encode_fwd.cu``) on CUDA tensors
and ``hash_encode_fwd_plain`` (one [2^D, N, C] gather per level) on CPU
tensors.  The forward keeps no corner values: the backward recomputes the
geometry and, when the inputs need a gradient, gathers the corners again,
in kernel G1b (``csrc/hash_encode_bwd.cu``, ``hash_encode_bwd``) on CUDA
tensors and in ``hash_encode_bwd_plain`` on CPU tensors; the embedding
gradient is then the sorted segment sum (K3,
``hash_grid_bwd.hash_grad_embeddings``).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.autograd.function import once_differentiable

from gaussiancity_tpu_torch import _kernels
from gaussiancity_tpu_torch.ops import hash_grid_bwd
from gaussiancity_tpu_torch.utils import profiling

_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_U32 = 0xFFFFFFFF


def level_params(in_channels: int, n_levels: int, base_resolution: int,
                 desired_resolution: int, log2_hashmap_size: int
                 ) -> Tuple[float, Sequence[int], Sequence[int],
                            Sequence[bool], int]:
    """Static per-level layout: (per_level_scale, offsets, resolutions,
    hashed flags, total_rows)."""
    per_level_scale = 2.0 ** (
        math.log2(desired_resolution / base_resolution) / (n_levels - 1))
    max_params = 2 ** log2_hashmap_size
    offsets, resolutions, hashed = [], [], []
    offset = 0
    S = math.log2(per_level_scale)
    for lvl in range(n_levels):
        scale = (2.0 ** (lvl * S)) * base_resolution - 1.0
        resolution = int(np.ceil(scale)) + 1
        corners = (resolution + 1) ** in_channels
        params_in_level = int(np.ceil(min(max_params, corners) / 8) * 8)
        offsets.append(offset)
        resolutions.append(resolution)
        hashed.append(corners > params_in_level)
        offset += params_in_level
    return per_level_scale, offsets, resolutions, hashed, offset


def level_scales(n_levels: int, base_resolution: int,
                 desired_resolution: int) -> Sequence[float]:
    """Per-level scale ``2^(l * log2(s)) * base - 1`` (Python floats)."""
    S = math.log2(desired_resolution / base_resolution) / (n_levels - 1)
    return [(2.0 ** (lvl * S)) * base_resolution - 1.0
            for lvl in range(n_levels)]


def _level_rows(offsets, total):
    bounds = list(offsets) + [total]
    return [bounds[l + 1] - bounds[l] for l in range(len(offsets))]


def table_shape(in_channels: int, n_levels: int, base_resolution: int,
                desired_resolution: int, log2_hashmap_size: int,
                lvl_channels: int) -> Tuple[int, int, int]:
    """The [L, R_max, C] embedding-table shape."""
    _, offsets, _, _, total = level_params(
        in_channels, n_levels, base_resolution, desired_resolution,
        log2_hashmap_size)
    return n_levels, max(_level_rows(offsets, total)), lvl_channels


def repack_legacy_table(packed, in_channels: int, n_levels: int,
                        base_resolution: int, desired_resolution: int,
                        log2_hashmap_size: int) -> np.ndarray:
    """Migrate a round-1 packed ``[total_rows, C]`` embedding table to the
    current ``[L, R_max, C]`` layout (row ``r`` of level ``l`` lives at
    packed row ``offsets[l] + r``; rows past a level's size are zero)."""
    packed = np.asarray(packed)
    total, C = packed.shape
    _, offsets, _, _, expect_total = level_params(
        in_channels, n_levels, base_resolution, desired_resolution,
        log2_hashmap_size)
    if total != expect_total:
        raise ValueError(
            f"packed table has {total} rows; the level layout expects "
            f"{expect_total}: not a legacy GridEncoder table")
    rows = _level_rows(offsets, expect_total)
    out = np.zeros((n_levels, max(rows), C), packed.dtype)
    for lvl in range(n_levels):
        out[lvl, :rows[lvl]] = packed[offsets[lvl]:offsets[lvl] + rows[lvl]]
    return out


def raise_if_legacy_table(saved_shapes: Dict[str, Tuple[int, ...]],
                          want: Sequence[int], where: str) -> None:
    """Refuse a checkpoint whose hash table is a round-1 packed 2-D
    ``[total_rows, C]`` ``…embeddings`` leaf where the model wants
    ``[L, R_max, C]`` (``want``), naming the migration.  ``saved_shapes``
    maps each saved leaf's path to its shape; called before any weight is
    loaded."""
    for name, shape in saved_shapes.items():
        if (name.endswith("embeddings") and shape is not None
                and len(shape) == 2 and len(want) == 3):
            raise ValueError(
                f"checkpoint {where} stores a legacy packed hash table "
                f"'{name}' of shape {tuple(shape)} but the current "
                f"GridEncoder expects {tuple(want)} ([levels, rows, "
                "channels]).  Migrate it once with gaussiancity_tpu_torch."
                "ops.hash_grid.repack_legacy_table(packed, in_channels, "
                "n_levels, base_resolution, desired_resolution, "
                "log2_hashmap_size) and re-save; row r of level l == packed "
                "row offsets[l]+r.")


def corner_bits(D: int, device=None) -> torch.Tensor:
    """[2^D, D] corner offsets (bit d of the corner index)."""
    c = torch.arange(1 << D, device=device)
    return (c[:, None] >> torch.arange(D, device=device)[None, :]) & 1


def hash_u32(pc: torch.Tensor) -> torch.Tensor:
    """XOR-prime hash of int64 lattice points [..., D] as the uint32 value
    (held in int64) that wrapping uint32 arithmetic gives."""
    idx = torch.zeros_like(pc[..., 0])
    for d in range(pc.shape[-1]):
        idx = idx ^ ((pc[..., d] * _PRIMES[d]) & _U32)
    return idx


def corner_indices(grid: torch.Tensor, hashed: bool, resolution: int,
                   rows: int) -> torch.Tensor:
    """Level-local table rows [2^D, N] of the 2^D corners of each point's
    cell; ``grid`` [N, D] int64 holds floor(pos)."""
    D = grid.shape[1]
    pc = grid[None] + corner_bits(D, grid.device)[:, None, :]
    if hashed:
        idx = hash_u32(pc)
    else:
        idx = torch.zeros_like(pc[..., 0])
        stride = 1
        for d in range(D):
            idx = idx + pc[..., d] * stride
            stride *= resolution + 1
    return idx % rows


def _level_geometry(inputs: torch.Tensor, D: int, n_levels: int,
                    base_resolution: int, desired_resolution: int,
                    log2_hashmap_size: int, bound: float):
    """Per-level corner rows and weights: (idx [L, 2^D, N] int32, frac
    [L, D, N], w [L, 2^D, N], oob [N], level scales)."""
    _, offsets, resolutions, hashed, total = level_params(
        D, n_levels, base_resolution, desired_resolution, log2_hashmap_size)
    level_rows = _level_rows(offsets, total)
    scales = level_scales(n_levels, base_resolution, desired_resolution)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which kernel G1 does not
    x01 = (inputs + bound) / torch.tensor(2.0 * bound, dtype=inputs.dtype,
                                          device=inputs.device)
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    bits = corner_bits(D, inputs.device)
    idx, fracs, ws = [], [], []
    for lvl, scale in enumerate(scales):
        pos = x01 * scale + 0.5  # [N, D]
        g = torch.floor(pos)
        frac = pos - g
        w = torch.ones((1 << D, inputs.shape[0]), dtype=frac.dtype,
                       device=frac.device)
        for d in range(D):
            w = w * torch.where(bits[:, None, d] == 1, frac[None, :, d],
                                1.0 - frac[None, :, d])
        idx.append(corner_indices(g.long(), hashed[lvl], resolutions[lvl],
                                  level_rows[lvl]).to(torch.int32))
        fracs.append(frac.T)
        ws.append(w)
    return (torch.stack(idx), torch.stack(fracs), torch.stack(ws), oob,
            scales)


def hash_encode_fwd_plain(inputs: torch.Tensor, embeddings: torch.Tensor,
                          n_levels: int, base_resolution: int,
                          desired_resolution: int, log2_hashmap_size: int,
                          bound: float = 1.0) -> torch.Tensor:
    """Plain version of G1: one [2^D, N, C] gather per level (each level
    reads only its own [R_max, C] block), weighted and summed over the
    corners.  inputs [N, D], embeddings [L, R_max, C] -> [N, L * C]."""
    idx, _, w, oob, _ = _level_geometry(
        inputs, inputs.shape[1], n_levels, base_resolution,
        desired_resolution, log2_hashmap_size, bound)
    out = torch.cat([(embeddings[lvl][idx[lvl].long()]
                      * w[lvl, ..., None]).sum(dim=0)
                     for lvl in range(n_levels)], dim=-1)
    return torch.where(oob[:, None], torch.zeros_like(out), out)


_level_tables: Dict[tuple, torch.Tensor] = {}


def level_table(in_channels: int, n_levels: int, base_resolution: int,
                desired_resolution: int, log2_hashmap_size: int,
                device) -> torch.Tensor:
    """G1's per-level parameters [L, 4] int32 on ``device``: the level
    scale (computed in double, rounded to float32 as the plain version's
    Python float is, and kept as its bits), the resolution, the hashed
    flag and the level's row count."""
    key = (in_channels, n_levels, base_resolution, desired_resolution,
           log2_hashmap_size, str(device))
    table = _level_tables.get(key)
    if table is None:
        _, offsets, resolutions, hashed, total = level_params(
            in_channels, n_levels, base_resolution, desired_resolution,
            log2_hashmap_size)
        scales = np.array(level_scales(n_levels, base_resolution,
                                       desired_resolution), np.float32)
        rows = np.stack([scales.view(np.int32),
                         np.asarray(resolutions, np.int32),
                         np.asarray(hashed, np.int32),
                         np.asarray(_level_rows(offsets, total), np.int32)],
                        axis=1)
        table = torch.as_tensor(rows, device=device)
        _level_tables[key] = table
    return table


def hash_encode_fwd(inputs: torch.Tensor, embeddings: torch.Tensor,
                    n_levels: int, base_resolution: int,
                    desired_resolution: int, log2_hashmap_size: int,
                    bound: float = 1.0) -> torch.Tensor:
    """The hash-grid forward, inputs [N, D] float32 and embeddings
    [L, R_max, C] float32 -> [N, L * C].  CUDA tensors go to kernel G1,
    CPU tensors to the plain version."""
    if inputs.device != embeddings.device:
        raise ValueError(f"inputs are on {inputs.device}, embeddings on "
                         f"{embeddings.device}")
    if inputs.dtype != torch.float32 or embeddings.dtype != torch.float32:
        raise TypeError("inputs and embeddings must be float32, got "
                        f"{inputs.dtype} and {embeddings.dtype}")
    if inputs.dim() != 2 or embeddings.dim() != 3 \
            or embeddings.shape[0] != n_levels:
        raise ValueError(f"inputs must be [N, D] and embeddings "
                         f"[{n_levels}, R_max, C], got {tuple(inputs.shape)}"
                         f" and {tuple(embeddings.shape)}")
    args = (n_levels, base_resolution, desired_resolution,
            log2_hashmap_size, bound)
    if not inputs.is_cuda:
        return hash_encode_fwd_plain(inputs, embeddings, *args)
    N, D = inputs.shape
    _, R_max, C = embeddings.shape
    if not 1 <= D <= 7 or not 1 <= C <= 16:
        raise ValueError("kernel G1 takes 1..7 inputs and 1..16 channels")
    if not inputs.is_contiguous() or not embeddings.is_contiguous():
        raise ValueError("inputs and embeddings must be contiguous")
    if C == 8 and embeddings.data_ptr() % 16:
        raise ValueError("kernel G1 loads 8-channel rows as float4: the "
                         "table must be 16-byte aligned")
    if N >= 2 ** 31 or R_max >= 2 ** 31:
        raise ValueError("kernel G1 counts points and rows in int32")
    levels = level_table(D, n_levels, base_resolution, desired_resolution,
                         log2_hashmap_size, inputs.device)
    out = torch.empty((N, n_levels * C), dtype=torch.float32,
                      device=inputs.device)
    if N:
        _kernels.launch("hash_encode_fwd", inputs.data_ptr(),
                        embeddings.data_ptr(), levels.data_ptr(), N, D,
                        n_levels, R_max, C, float(bound),
                        float(np.float32(2.0 * bound)), out.data_ptr(),
                        _kernels.stream_handle(inputs.device))
    return out


def hash_encode_bwd_plain(inputs: torch.Tensor, embeddings: torch.Tensor,
                          g: torch.Tensor, n_levels: int,
                          base_resolution: int, desired_resolution: int,
                          log2_hashmap_size: int, bound: float = 1.0,
                          need_embeddings: bool = True,
                          need_inputs: bool = True):
    """Plain version of G1b, the backward of ``hash_encode`` up to the
    segment sum: the JAX package's ``_hash_encode_bwd``
    (``hash_grid.py:248-300``) with the corner rows and weights recomputed
    and the corner values gathered again, one level at a time.

    inputs [N, D], embeddings [L, R_max, C], g [N, L * C] ->
    (keys [L, 2^D, N] int32, weights [L, 2^D, N], g_l [L, N, C],
    d_inputs [N, D]): K3's inputs (``hash_grid_bwd.hash_grad_embeddings``;
    g_l is the gradient per level, 0 for out-of-bound points), None unless
    ``need_embeddings``, and the input gradient, None unless
    ``need_inputs``."""
    D = inputs.shape[1]
    idx, frac, w, oob, scales = _level_geometry(
        inputs, D, n_levels, base_resolution, desired_resolution,
        log2_hashmap_size, bound)
    L, NC, N = w.shape
    C = embeddings.shape[2]
    gm = torch.where(oob[:, None], torch.zeros_like(g), g)
    g_l = gm.reshape(N, L, C).transpose(0, 1).contiguous()  # [L, N, C]
    d_inputs = None
    if need_inputs:
        # dw[l, c, n] = <value of corner c, g_l[l, n]>, one level's
        # [2^D, N, C] corner values at a time
        dw = torch.stack([
            (embeddings[lvl][idx[lvl].long()] * g_l[lvl][None]).sum(-1)
            for lvl in range(L)])  # [L, 2^D, N]
        bits = corner_bits(D, g.device)
        scales = torch.tensor(scales, dtype=frac.dtype, device=g.device)
        d_x01 = []
        for d in range(D):
            prod = torch.ones_like(dw)
            for d2 in range(D):
                if d2 != d:
                    f = frac[:, None, d2, :]
                    prod = prod * torch.where(bits[None, :, d2, None] == 1,
                                              f, 1.0 - f)
            sign = torch.where(bits[:, d] == 1, 1.0, -1.0)[None, :, None]
            dfrac = (dw * sign * prod).sum(dim=1)  # [L, N]
            # pos = x01 * scale + 0.5, so d x01 = scale * d frac
            d_x01.append((dfrac * scales[:, None]).sum(dim=0))
        d_inputs = torch.stack(d_x01, dim=-1) / (2.0 * bound)
        d_inputs = torch.where(oob[:, None], torch.zeros_like(d_inputs),
                               d_inputs)
    if not need_embeddings:
        return None, None, None, d_inputs
    return idx, w, g_l, d_inputs


def hash_encode_bwd(inputs: torch.Tensor, embeddings: torch.Tensor,
                    g: torch.Tensor, n_levels: int, base_resolution: int,
                    desired_resolution: int, log2_hashmap_size: int,
                    bound: float = 1.0, need_embeddings: bool = True,
                    need_inputs: bool = True):
    """The hash-grid backward up to the segment sum; inputs, outputs and
    None-ness as ``hash_encode_bwd_plain``.  CUDA tensors go to kernel G1b
    (one launch, then one ``sum`` over the levels for ``d_inputs``), CPU
    tensors to the plain version."""
    if not inputs.device == embeddings.device == g.device:
        raise ValueError(f"inputs are on {inputs.device}, embeddings on "
                         f"{embeddings.device}, g on {g.device}")
    if any(t.dtype != torch.float32 for t in (inputs, embeddings, g)):
        raise TypeError("inputs, embeddings and g must be float32, got "
                        f"{inputs.dtype}, {embeddings.dtype} and {g.dtype}")
    N, D = inputs.shape
    L, R_max, C = embeddings.shape
    if L != n_levels or tuple(g.shape) != (N, L * C):
        raise ValueError(f"inputs [N, D], embeddings [{n_levels}, R_max, C]"
                         f" and g [N, {n_levels} * C] expected, got "
                         f"{tuple(inputs.shape)}, {tuple(embeddings.shape)}"
                         f" and {tuple(g.shape)}")
    args = (n_levels, base_resolution, desired_resolution,
            log2_hashmap_size, bound, need_embeddings, need_inputs)
    if not inputs.is_cuda:
        return hash_encode_bwd_plain(inputs, embeddings, g, *args)
    if not 1 <= D <= 7 or not 1 <= C <= 16:
        raise ValueError("kernel G1b takes 1..7 inputs and 1..16 channels")
    if not all(t.is_contiguous() for t in (inputs, embeddings, g)):
        raise ValueError("inputs, embeddings and g must be contiguous")
    if C == 8 and (embeddings.data_ptr() % 16 or g.data_ptr() % 16):
        raise ValueError("kernel G1b loads 8-channel rows as float4: the "
                         "table and g must be 16-byte aligned")
    if N >= 2 ** 31 or R_max >= 2 ** 31:
        raise ValueError("kernel G1b counts points and rows in int32")
    levels = level_table(D, n_levels, base_resolution, desired_resolution,
                         log2_hashmap_size, inputs.device)
    dev = inputs.device
    keys = weights = g_l = part = d_inputs = None
    if need_embeddings:
        keys = torch.empty((L, 1 << D, N), dtype=torch.int32, device=dev)
        weights = torch.empty((L, 1 << D, N), dtype=torch.float32,
                              device=dev)
        g_l = torch.empty((L, N, C), dtype=torch.float32, device=dev)
    if need_inputs:
        part = torch.empty((L, N, D), dtype=torch.float32, device=dev)
    if N and (need_embeddings or need_inputs):
        outs = [None if t is None else t.data_ptr()
                for t in (keys, weights, g_l, part)]
        _kernels.launch("hash_encode_bwd", inputs.data_ptr(),
                        embeddings.data_ptr(), levels.data_ptr(),
                        g.data_ptr(), N, D, n_levels, R_max, C, float(bound),
                        float(np.float32(2.0 * bound)), *outs,
                        _kernels.stream_handle(dev))
    if need_inputs:
        # the levels' contributions, each already over 2 * bound and 0 for
        # out-of-bound points, summed in one deterministic reduction
        d_inputs = part.sum(dim=0)
    return keys, weights, g_l, d_inputs


class _HashEncode(torch.autograd.Function):
    """The JAX package's ``hash_encode`` custom VJP: the embedding
    gradient is a sorted segment sum (kernel K3 on the card,
    ``hash_grid_bwd.hash_grad_embeddings``), the input gradient the
    closed-form multilinear chain (``hash_grid.py:275-298``).  The forward
    (G1) keeps only its inputs; the backward (G1b, ``hash_encode_bwd``)
    recomputes the corner rows and weights, and gathers the corner values
    again when the inputs need a gradient."""

    @staticmethod
    def forward(ctx, inputs, embeddings, geometry_args, bound):
        out = hash_encode_fwd(inputs.detach().contiguous(),
                              embeddings.detach(), *geometry_args, bound)
        ctx.save_for_backward(inputs, embeddings)
        ctx.geometry_args, ctx.bound = geometry_args, bound
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        inputs, embeddings = ctx.saved_tensors
        need_inputs, need_embeddings = ctx.needs_input_grad[:2]
        keys, weights, g_l, d_inputs = hash_encode_bwd(
            inputs.detach().contiguous(), embeddings.detach(),
            g.contiguous(), *ctx.geometry_args, ctx.bound, need_embeddings,
            need_inputs)
        d_emb = None
        if need_embeddings:
            d_emb = hash_grid_bwd.hash_grad_embeddings(
                keys, weights, g_l, embeddings.shape[1])
        return d_inputs, d_emb, None, None


def hash_encode(inputs: torch.Tensor, embeddings: torch.Tensor,
                in_channels: int, n_levels: int, base_resolution: int,
                desired_resolution: int, log2_hashmap_size: int,
                bound: float = 1.0) -> torch.Tensor:
    """inputs [N, D] -> [N, n_levels * C] (multilinear over the 2^D
    corners of each level).  Differentiable with respect to ``inputs`` and
    ``embeddings`` (``_HashEncode``)."""
    if inputs.shape[1] != in_channels:
        raise ValueError(f"inputs must be [N, {in_channels}]")
    return _HashEncode.apply(inputs, embeddings,
                             (n_levels, base_resolution, desired_resolution,
                              log2_hashmap_size), bound)


class GridEncoder(nn.Module):
    """Module owning the hash table (init uniform(-1e-4, 1e-4))."""

    def __init__(self, in_channels: int, n_levels: int = 16,
                 lvl_channels: int = 8, desired_resolution: int = 2048,
                 base_resolution: int = 16, log2_hashmap_size: int = 19):
        super().__init__()
        self.in_channels = in_channels
        self.n_levels = n_levels
        self.lvl_channels = lvl_channels
        self.desired_resolution = desired_resolution
        self.base_resolution = base_resolution
        self.log2_hashmap_size = log2_hashmap_size
        self.embeddings = nn.Parameter(torch.empty(table_shape(
            in_channels, n_levels, base_resolution, desired_resolution,
            log2_hashmap_size, lvl_channels)))
        self.reset_parameters()

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.lvl_channels

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        with torch.no_grad():
            self.embeddings.uniform_(-1e-4, 1e-4, generator=generator)

    def forward(self, inputs: torch.Tensor,
                bound: float = 1.0) -> torch.Tensor:
        prefix = inputs.shape[:-1]
        with profiling.span("hash_grid"):
            out = hash_encode(
                inputs.reshape(-1, self.in_channels), self.embeddings,
                self.in_channels, self.n_levels, self.base_resolution,
                self.desired_resolution, self.log2_hashmap_size, bound)
        return out.reshape(*prefix, self.output_dim)
