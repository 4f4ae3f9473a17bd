# -*- coding: utf-8 -*-
"""Dataset helpers that inference needs (counterpart of part of
``gaussiancity_tpu/data/datasets.py``)."""

from __future__ import annotations

import numpy as np

from gaussiancity_tpu_torch.config import DatasetConfig


def instances_to_classes_np(instances: np.ndarray, ds: DatasetConfig):
    """Instance id -> class id on the host (upstream utils/datasets.py
    :265-282, 334-352)."""
    inst = instances.astype(np.int64)
    out = inst.copy()
    in_bldg = (inst >= ds.bldg_range[0]) & (inst < ds.bldg_range[1])
    out[in_bldg & (inst % 2 == 0)] = ds.bldg_facade_clsid
    out[in_bldg & (inst % 2 == 1)] = ds.bldg_roof_clsid
    if ds.car_range is not None:
        in_car = (inst >= ds.car_range[0]) & (inst < ds.car_range[1])
        out[in_car] = ds.car_clsid
    return out
