# -*- coding: utf-8 -*-
"""Run logs (counterpart of ``gaussiancity_tpu/utils/summary_writer.py``;
upstream utils/summary_writer.py:22-99).

``add_config`` / ``add_scalars`` / ``add_images`` / ``close`` under
``output_dir/logs/<exp_name>/``.  A JSONL file of scalars is always
written; images go to ``images/`` as PNG where ``imageio`` imports and as
``.npy`` where it does not.  TensorBoard (``tensorboardX``) is used
whenever it imports.  Create one writer, on the rank-0 process."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class SummaryWriter:
    def __init__(self, output_dir: str, exp_name: str = ""):
        self.log_dir = os.path.join(output_dir, "logs", exp_name or "default")
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter as TBWriter
        except ImportError:
            TBWriter = None
        self._tb = TBWriter(self.log_dir) if TBWriter is not None else None

    def add_config(self, cfg_dict: Dict):
        with open(os.path.join(self.log_dir, "config.json"), "w") as f:
            json.dump(cfg_dict, f, indent=2)

    def add_scalars(self, scalars: Dict[str, float], step: int):
        rec = {"step": step, "ts": time.time(),
               **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def add_images(self, images: Dict[str, np.ndarray], step: int):
        """images: name -> HWC uint8, or float in [0, 1]."""
        img_dir = os.path.join(self.log_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        try:
            import imageio
        except ImportError:
            imageio = None
        for k, v in images.items():
            arr = np.asarray(v)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            if self._tb is not None:
                self._tb.add_image(k, arr, step, dataformats="HWC")
            stem = os.path.join(img_dir, f"{k.replace('/', '_')}_{step:06d}")
            if imageio is not None:
                imageio.imwrite(stem + ".png", arr)
            else:
                np.save(stem + ".npy", arr)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
