# -*- coding: utf-8 -*-
"""Rasterizer debug snapshots (counterpart of
``gaussiancity_tpu/ops/rasterizer/debug.py``; upstream's ``debug=True``
path, extensions/diff_gaussian_rasterization/__init__.py:65-83, which
dumps every rasterizer input when a kernel faults).

``rasterize_checked`` renders, checks the outputs on the host, and when
the image or the final transmittance holds a non-finite value pickles
every input (numpy arrays, the camera with its tensors on the CPU, the
config) so that the render can be replayed::

    out = rasterize_checked(means, opac, scales, quats, colors, cam, cfg)
    ...
    snap = load_snapshot(path)
    rasterize(**{k: torch.from_numpy(v) for k, v in snap["arrays"].items()},
              cam=snap["cam"], cfg=snap["cfg"])

The check adds one device-to-host read a call: a tool for debugging, not
for the training loop.
"""

from __future__ import annotations

import logging
import os
import pickle
import tempfile
from typing import Optional

import numpy as np
import torch

from gaussiancity_tpu_torch.ops.rasterizer.api import RenderOutput, rasterize


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return value


def dump_snapshot(path: str, arrays: dict, cam=None, cfg=None,
                  note: str = "") -> str:
    """Pickle a dict of arrays (as numpy) with the camera and config."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if cam is not None:
        cam = type(cam)(*(_host(v) for v in cam))
    payload = {
        "arrays": {k: np.asarray(_host(v)) for k, v in arrays.items()
                   if v is not None},
        "cam": cam, "cfg": cfg, "note": note,
    }
    with open(path, "wb") as fp:
        pickle.dump(payload, fp)
    return path


def load_snapshot(path: str) -> dict:
    with open(path, "rb") as fp:
        return pickle.load(fp)


def default_snapshot_path() -> str:
    return os.path.join(tempfile.gettempdir(), "snapshot_fw.pkl")


def rasterize_checked(means3d, opacities, scales, quats, colors, cam, cfg,
                      snapshot_path: Optional[str] = None,
                      raise_on_nonfinite: bool = True,
                      **kwargs) -> RenderOutput:
    """``rasterize`` and a host-side finiteness check of its image and
    final T.  On a non-finite value every input goes to
    ``snapshot_path`` (default ``snapshot_fw.pkl`` in the temporary
    directory) and, unless ``raise_on_nonfinite`` is False, a
    ``FloatingPointError`` names the file."""
    out = rasterize(means3d, opacities, scales, quats, colors, cam, cfg,
                    **kwargs)
    finite = bool(torch.isfinite(out.image).all()
                  & torch.isfinite(out.final_T).all())
    if not finite:
        path = snapshot_path or default_snapshot_path()
        arrays = dict(means3d=means3d, opacities=opacities, scales=scales,
                      quats=quats, colors=colors)
        arrays.update({k: v for k, v in kwargs.items()
                       if isinstance(v, (np.ndarray, torch.Tensor))})
        dump_snapshot(path, arrays, cam=cam, cfg=cfg,
                      note="non-finite rasterize output")
        logging.error("rasterize produced non-finite output; inputs "
                      "dumped to %s", path)
        if raise_on_nonfinite:
            raise FloatingPointError(
                f"non-finite rasterize output (snapshot: {path})")
    return out
