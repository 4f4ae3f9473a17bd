# -*- coding: utf-8 -*-
"""Deterministic sorted segment sum (counterpart of
``gaussiancity_tpu/ops/hash_grid_bwd.py``; upstream grid_encoder backward,
grid_encoder_ext.cu:141-249, and the per-Gaussian atomicAdd of
backward.cu:547-578).

``segment_sum_sorted`` launches kernel K3 (``csrc/segment_sum.cu``) on
CUDA tensors and runs ``segment_sum_sorted_plain`` (``index_add_``) on CPU
tensors.  As in the JAX package, the sort of the keys and the gather of the
payload into sorted order happen outside the kernel (``torch.sort`` with
``stable=True`` and indexing here, ``lax.sort`` and an XLA gather there).

Two callers:

- ``hash_grad_embeddings``: the hash-grid embedding gradient, per level;
- ``reduce_rows``: the rasterizer's per-(tile, slot) gradient rows summed
  into per-Gaussian rows.
"""

from __future__ import annotations

import torch

from gaussiancity_tpu_torch import _kernels

MAX_CHANNELS = 16  # payload channels the kernel keeps in registers


def segment_sum_sorted_plain(keys: torch.Tensor, rows: torch.Tensor,
                             n_rows: int) -> torch.Tensor:
    """Plain version of K3: ``index_add_`` per level; keys outside
    [0, n_rows) are dropped.  keys [L, M], rows [L, M, C] -> [L, R, C]."""
    L, M, C = rows.shape
    out = torch.zeros((L, n_rows, C), dtype=torch.float32,
                      device=rows.device)
    for lvl in range(L):
        k = keys[lvl].long()
        keep = (k >= 0) & (k < n_rows)
        out[lvl].index_add_(0, k[keep], rows[lvl][keep])
    return out


def _check_inputs(keys, rows, n_rows):
    if keys.device != rows.device:
        raise ValueError(f"keys are on {keys.device}, rows on {rows.device}")
    if keys.dtype != torch.int32 or rows.dtype != torch.float32:
        raise TypeError("keys must be int32 and rows float32, got "
                        f"{keys.dtype} and {rows.dtype}")
    if rows.dim() != 3 or tuple(keys.shape) != tuple(rows.shape[:2]):
        raise ValueError(f"keys must be [L, M] and rows [L, M, C], got "
                         f"{tuple(keys.shape)} and {tuple(rows.shape)}")
    if not keys.is_contiguous() or not rows.is_contiguous():
        raise ValueError("keys and rows must be contiguous")
    if not 0 < rows.shape[2] <= MAX_CHANNELS:
        raise ValueError(f"rows must have 1..{MAX_CHANNELS} channels")
    if n_rows >= 2 ** 31 or rows.shape[1] >= 2 ** 31:
        raise ValueError("the kernel indexes rows and keys with int32")


def segment_sum_sorted(keys: torch.Tensor, rows: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """Sum the rows of each run of equal keys into a dense table.

    ``keys`` [L, M] int32, ascending within each level; ``rows`` [L, M, C]
    float32 in the same order.  Returns [L, n_rows, C] float32: row r of
    level l is the sum, in sorted order, of the rows keyed r; rows that no
    key names are 0; keys outside [0, n_rows) are dropped.

    CUDA tensors go to kernel K3 (no atomics: bit-equal across runs); CPU
    tensors to the plain version."""
    _check_inputs(keys, rows, n_rows)
    if not rows.is_cuda:
        return segment_sum_sorted_plain(keys, rows, n_rows)
    L, M, C = rows.shape
    out = torch.empty((L, n_rows, C), dtype=torch.float32,
                      device=rows.device)
    if L and n_rows:
        _kernels.launch("segment_sum", keys.data_ptr(), rows.data_ptr(), L,
                        M, C, n_rows, out.data_ptr(),
                        _kernels.stream_handle(rows.device))
    return out


def reduce_rows(keys: torch.Tensor, rows: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """Sum ``rows`` [M, C] into [n_rows, C] by ``keys`` [M] (any order);
    keys outside [0, n_rows) are dropped.  Deterministic: a stable sort,
    then K3."""
    sk, order = torch.sort(keys.to(torch.int32), stable=True)
    return segment_sum_sorted(sk[None].contiguous(),
                              rows[order][None].contiguous(), n_rows)[0]


def hash_grad_embeddings(idx: torch.Tensor, w: torch.Tensor,
                         g_l: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Dense [L, n_rows, C] embedding gradient of a multilinear lookup.

    ``idx`` [L, NC, N] level-local table rows of the NC corners of each
    point, ``w`` [L, NC, N] their weights, ``g_l`` [L, N, C] the upstream
    gradient per level (out-of-bound points already zeroed).  As in the
    JAX package the corner weight rides through the sort and the small
    [N, C] gradient rows are gathered afterwards."""
    L, NC, N = idx.shape
    keys = idx.reshape(L, NC * N).to(torch.int32)
    sk, order = torch.sort(keys, dim=1, stable=True)
    w_s = torch.gather(w.reshape(L, NC * N), 1, order)
    point = order % N  # flattened position m = corner * N + point
    g_s = torch.gather(g_l, 1, point[..., None].expand(L, NC * N,
                                                       g_l.shape[2]))
    return segment_sum_sorted(sk.contiguous(),
                              (w_s[..., None] * g_s).contiguous(), n_rows)
