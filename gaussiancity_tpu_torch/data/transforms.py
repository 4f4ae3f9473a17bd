# -*- coding: utf-8 -*-
"""Point-cloud transforms on the host (counterpart of the helpers of
``gaussiancity_tpu/data/transforms.py`` that inference needs)."""

from __future__ import annotations

import numpy as np


def _normalize_rel_cords(pts: np.ndarray, centers) -> np.ndarray:
    """Per-instance normalized coordinates.  pts [N, >=5] with the
    instance id in column 4; centers maps id -> (cx, cy, w, h, d).
    Returns [N, 4]: rel_xyz + dense batch index."""
    ids = pts[:, 4].astype(np.int64)
    uniq, inv = np.unique(ids, return_inverse=True)
    ctr = np.array([centers.get(int(u), (0.0, 0.0, 0.0, 0.0, 0.0))
                    if hasattr(centers, "get") else centers[int(u)]
                    for u in uniq], dtype=np.float32).reshape(-1, 5)
    c = ctr[inv]  # [N, 5] -> cx, cy, w, h, d
    x = pts[:, 0].astype(np.float32)
    y = pts[:, 1].astype(np.float32)
    z = pts[:, 2].astype(np.float32)
    rel = np.zeros((len(pts), 3), np.float32)
    w, h, d = c[:, 2], c[:, 3], c[:, 4]
    rel[:, 0] = np.where(w > 0, (x - c[:, 0]) / np.maximum(w, 1e-9) * 2, 0)
    rel[:, 1] = np.where(h > 0, (y - c[:, 1]) / np.maximum(h, 1e-9) * 2, 0)
    rel[:, 2] = np.where(d > 0,
                         np.clip(z / np.maximum(d, 1e-9) * 2 - 1, -1, 1), 0)
    return np.concatenate([rel, inv.astype(np.float32)[:, None]], axis=1)
