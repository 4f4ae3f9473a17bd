# -*- coding: utf-8 -*-
"""Row gather with a channel sum, kernel K4 (counterpart of the Pallas
probe ``scripts/bench_gather3.py::kern``).

The JAX package probes whether a table kept in fast memory can be gathered
by row inside a kernel: a bf16 table [R, 8] and int32 indices [8, U / 8]
give the float32 channel sums of the gathered rows.  ``gather_rowsum``
launches K4 (``csrc/gather_rowsum.cu``) on CUDA tensors and runs
``gather_rowsum_plain`` on CPU tensors; ``probe_inputs`` makes the probe's
own shapes from a seed.  The system's gather of this kind is the hash-grid
forward, kernel G1 (``ops/hash_grid.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gaussiancity_tpu_torch import _kernels
from gaussiancity_tpu_torch.device import resolve_device

# the probe's shapes (bench_gather3.py:62-73): a 1 MB bf16 table of
# 65,536 rows x 8 channels and one hash level's 524,288 queries as [8, U/8]
PROBE_ROWS, PROBE_CHANNELS, PROBE_QUERIES = 65536, 8, 524288


def gather_rowsum_plain(table: torch.Tensor, idx: torch.Tensor
                        ) -> torch.Tensor:
    """out[...] = sum_k float(table[clamp(idx[...]), k]), the channels
    added in order k = 0..7 as K4 adds them."""
    rows = idx.long().clamp(0, table.shape[0] - 1)
    vals = table[rows].float()
    out = vals[..., 0]
    for k in range(1, vals.shape[-1]):
        out = out + vals[..., k]
    return out


def gather_rowsum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Channel sums of the ``table`` [R, 8] (bf16) rows at ``idx`` (int32,
    any shape); indices outside [0, R) are clamped.  CUDA tensors go to K4,
    CPU tensors to the plain version."""
    if table.device != idx.device:
        raise ValueError(f"table is on {table.device}, idx on {idx.device}")
    if table.dtype != torch.bfloat16 or idx.dtype != torch.int32:
        raise TypeError("table must be bfloat16 and idx int32, got "
                        f"{table.dtype} and {idx.dtype}")
    if table.dim() != 2 or table.shape[1] != 8 or table.shape[0] == 0:
        raise ValueError(f"table must be [R, 8], got {tuple(table.shape)}")
    if table.shape[0] >= 2 ** 31:
        raise ValueError("the kernel indexes rows with int32")
    if not table.is_cuda:
        return gather_rowsum_plain(table, idx)
    if not table.is_contiguous() or not idx.is_contiguous():
        raise ValueError("table and idx must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("the kernel loads 16-byte rows: table must be "
                         "16-byte aligned")
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    if idx.numel():
        _kernels.launch("gather_rowsum", table.data_ptr(), idx.data_ptr(),
                        table.shape[0], idx.numel(), out.data_ptr(),
                        _kernels.stream_handle(idx.device))
    return out


def probe_inputs(seed: int = 0, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe's table (bf16 [65,536, 8], normal) and indices (int32
    [8, 65,536], uniform over the rows), drawn with numpy from ``seed``,
    on the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    table = torch.as_tensor(rng.normal(
        size=(PROBE_ROWS, PROBE_CHANNELS)).astype(np.float32),
        device=device).to(torch.bfloat16)
    idx = torch.as_tensor(rng.integers(
        0, PROBE_ROWS, (8, PROBE_QUERIES // 8)).astype(np.int32),
        device=device)
    return table, idx
