# -*- coding: utf-8 -*-
"""Typed file reads, dispatched on the extension (counterpart of
``gaussiancity_tpu/data/io.py``; upstream utils/io.py:38-112): png / jpg
images (PIL, imported at the first image read), pickles, npy / npz, the
camera-pose csv and json.

Binary reads go through an optional byte cache installed with
``IO.configure_cache``: any object with ``get_file(path) -> bytes | None``
and ``set_file(path, blob)``.  A miss reads the disk and fills the cache.
The port ships no cache client yet (the memcached client is a later
slice)."""

from __future__ import annotations

import csv
import io as _io
import json
import os
import pickle
from typing import Any, Dict

import numpy as np


class IO:
    _cache = None  # an object with get_file / set_file, or None

    @classmethod
    def configure_cache(cls, client) -> None:
        """Install (or clear, with None) the byte cache of binary reads."""
        cls._cache = client

    @classmethod
    def _read_bytes(cls, path: str) -> bytes:
        if cls._cache is not None:
            blob = cls._cache.get_file(path)
            if blob is not None:
                return blob
        with open(path, "rb") as f:
            blob = f.read()
        if cls._cache is not None:
            cls._cache.set_file(path, blob)
        return blob

    @classmethod
    def get(cls, path: str) -> Any:
        ext = os.path.splitext(path)[1].lower()
        if ext in (".png", ".jpg", ".jpeg"):
            return cls._read_img(path)
        if ext in (".pkl", ".pickle"):
            return cls._read_pkl(path)
        if ext in (".npy", ".npz"):
            if cls._cache is not None:
                return np.load(_io.BytesIO(cls._read_bytes(path)),
                               allow_pickle=False)
            return np.load(path)
        if ext == ".csv":
            return cls._read_csv(path)
        if ext == ".json":
            with open(path) as f:
                return json.load(f)
        raise ValueError(f"Unsupported file extension: {ext}")

    @classmethod
    def _read_img(cls, path: str):
        from PIL import Image

        if cls._cache is not None:
            return Image.open(_io.BytesIO(cls._read_bytes(path)))
        return Image.open(path)

    @classmethod
    def _read_pkl(cls, path: str):
        if cls._cache is not None:
            return pickle.loads(cls._read_bytes(path))
        with open(path, "rb") as f:
            return pickle.load(f)

    @classmethod
    def _read_csv(cls, path: str) -> Dict[int, Dict[str, float]]:
        """csv -> {id: row} keyed by the first column (upstream
        utils/io.py:96-112)."""
        out = {}
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            key = reader.fieldnames[0]
            for row in reader:
                out[int(float(row[key]))] = {
                    k: float(v) for k, v in row.items() if k != key}
        return out
