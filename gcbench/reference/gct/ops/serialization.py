# -*- coding: utf-8 -*-
"""Space-filling-curve point serialization for PTv3 (counterpart of
``gaussiancity_tpu/ops/serialization.py``; upstream models/pt_v3.py:95-445).

Five orders: ``cord`` (coordinate-lexicographic decimal packing), ``z`` /
``z-trans`` (Morton) and ``hilbert`` / ``hilbert-trans`` (Skilling
transform).  Codes are exact int32 values computed with the JAX package's
bit operations (its hilbert codes, not upstream's); invalid points get
``INVALID_CODE`` so that a stable argsort moves them to the end.

Divisions by the grid size use a float32 tensor divisor on the input's
device: CUDA divides by a Python scalar as a multiplication by its
reciprocal, which moves some truncated codes by one.
"""

from __future__ import annotations

from typing import Tuple

import torch

INVALID_CODE = 2 ** 31 - 1


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def grid_coords(coord: torch.Tensor, grid_size: float,
                valid: torch.Tensor) -> torch.Tensor:
    """trunc((coord - min) / grid_size) as int32 [N, 3]; the min runs over
    valid points only and invalid points get 0."""
    big = torch.full_like(coord, 3.4e38)
    cmin = torch.where(valid[:, None], coord, big).amin(dim=0)
    g = torch.trunc((coord - cmin) / _f32(grid_size, coord)).to(torch.int32)
    return torch.where(valid[:, None], g, torch.zeros_like(g))


def cord_encode(g: torch.Tensor, grid_size: float) -> torch.Tensor:
    """x / gs^2 + y / gs + z in float32, truncated to int32."""
    x, y, z = (g[:, i].to(torch.float32) for i in range(3))
    code = x / _f32(grid_size ** 2, x) + y / _f32(grid_size, x) + z
    return code.to(torch.int32)


def _part_1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 ``v`` two zero bits apart."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def z_order_encode(g: torch.Tensor, depth: int = 10) -> torch.Tensor:
    """Morton code, x in the highest bit of each triple."""
    if depth > 10:
        raise ValueError("int32 codes hold at most depth 10")
    g = g.to(torch.int32)
    return ((_part_1by2(g[:, 0]) << 2) | (_part_1by2(g[:, 1]) << 1)
            | _part_1by2(g[:, 2]))


def hilbert_encode(g: torch.Tensor, depth: int = 10) -> torch.Tensor:
    """Hilbert index: Skilling's inverse transform, Gray decode, then
    Morton packing of the transposed bits (the JAX package's bit order)."""
    if depth > 10:
        raise ValueError("int32 codes hold at most depth 10")
    x, y, z = (g[:, i].to(torch.int32) for i in range(3))
    for i in range(depth - 1, 0, -1):
        q = 1 << i
        p = q - 1
        x = torch.where((x & q) != 0, x ^ p, x)
        for axis in (1, 2):
            v = y if axis == 1 else z
            m = (v & q) != 0
            x2 = torch.where(m, x ^ p, x)
            t = (x ^ v) & p
            v = torch.where(m, v, v ^ t)
            x = torch.where(m, x2, x2 ^ t)
            if axis == 1:
                y = v
            else:
                z = v
    y = y ^ x
    z = z ^ y
    t = torch.zeros_like(x)
    for i in range(depth - 1, 0, -1):
        q = 1 << i
        t = torch.where((z & q) != 0, t ^ (q - 1), t)
    x, y, z = x ^ t, y ^ t, z ^ t
    return (_part_1by2(x) << 2) | (_part_1by2(y) << 1) | _part_1by2(z)


def encode(g: torch.Tensor, grid_size: float, order: str,
           depth: int = 10) -> torch.Tensor:
    if order == "cord":
        return cord_encode(g, grid_size)
    if order == "z":
        return z_order_encode(g, depth)
    if order == "z-trans":
        return z_order_encode(g[:, [1, 0, 2]], depth)
    if order == "hilbert":
        return hilbert_encode(g, depth)
    if order == "hilbert-trans":
        return hilbert_encode(g[:, [1, 0, 2]], depth)
    raise NotImplementedError(order)


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """Row-wise inverse of the permutations ``order`` [O, N], int32."""
    ar = torch.arange(order.shape[1], dtype=torch.int32,
                      device=order.device).expand_as(order)
    return torch.empty_like(ar).scatter_(1, order.long(), ar)


def sort_codes(codes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable argsort of each row of ``codes`` [O, N] and its inverse,
    both int32."""
    order = torch.argsort(codes, dim=1, stable=True).to(torch.int32)
    return order, inverse_permutation(order)


def serialize(coord: torch.Tensor, valid: torch.Tensor, grid_size: float,
              orders: Tuple[str, ...], depth: int = 10):
    """(grid_coord [N, 3], codes [O, N], order [O, N], inverse [O, N]):
    invalid points carry ``INVALID_CODE``; ``order`` is a stable argsort
    of each order's codes and ``inverse`` its inverse permutation."""
    g = grid_coords(coord, grid_size, valid)
    invalid = torch.full((coord.shape[0],), INVALID_CODE, dtype=torch.int32,
                         device=coord.device)
    codes = torch.stack([torch.where(valid, encode(g, grid_size, o, depth),
                                     invalid) for o in orders])
    order, inverse = sort_codes(codes)
    return g, codes, order, inverse
