# -*- coding: utf-8 -*-
"""Read the JAX package's Orbax checkpoints without JAX, Orbax or
TensorStore (the writer is ``gaussiancity_tpu/training/checkpoint.py``).

A checkpoint directory holds one subdirectory per step, named by its
number and holding ``_CHECKPOINT_METADATA``; a step still being written
is named ``<step>.orbax-checkpoint-tmp-<n>`` and is ignored, as Orbax's
``latest_step`` ignores it.  A step holds two items:

- ``meta/metadata``: JSON ``{"cfg": Config.to_dict(), "epoch": int}``;
- ``state/``: the ``TrainState`` pytree.  ``_METADATA`` lists every leaf
  by its key path (``key_type`` 2 a dict key or a named-tuple field, 1 a
  sequence index) with its value type: an array, or a ``None`` / empty
  container that holds no data.  The arrays are zarr v2 arrays in an OCDBT
  store (``ocdbt.OcdbtStore``), each under the key path joined with
  ``.``: ``<name>/.zarray``
  and one ``<name>/<i>.<j>...`` key per chunk (``0`` for a scalar).
  Names are rebuilt from ``_METADATA``, never split: a spectral-norm leaf
  is named ``d_stats.enc1.SpectralNorm_0.Conv_0/kernel/u``.

Arrays: C or F order, any chunk grid assembled into one array, no
compressor or zstd (``native.zstd_decompress``), a missing chunk read as
the fill value (zeros where it is null), the dtypes numpy names
(``<f4``, ``<f2``, ``<i4``, ``<i8``, ``<u4``, ``|b1``, ``|u1``, ...) and
``bfloat16``, kept bit-exact: a bf16 leaf is read as uint16 and returned
as a ``torch.bfloat16`` tensor, every other leaf as a numpy array.
Arrays decode in a thread pool (ctypes releases the GIL in the decoder).
"""

from __future__ import annotations

import json
import math
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gaussiancity_tpu_torch import native
from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.training.ocdbt import OcdbtStore

CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
_TMP = re.compile(r"\.orbax-checkpoint-tmp-")
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
_EMPTY = ("None", "Dict", "List", "Tuple")

KeyPath = Tuple[str, ...]


def checkpoint_steps(directory: str) -> List[int]:
    """The finished steps under ``directory``, in order."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if (name.isdigit() and not _TMP.search(name) and os.path.isfile(
                os.path.join(directory, name, CHECKPOINT_METADATA))):
            steps.append(int(name))
    return sorted(steps)


def is_orbax_directory(directory: str) -> bool:
    """Whether ``directory`` holds Orbax steps (finished or not)."""
    if not os.path.isdir(directory):
        return False
    return any(name.split(".")[0].isdigit() and (
        _TMP.search(name) or os.path.isfile(
            os.path.join(directory, name, CHECKPOINT_METADATA)))
        for name in os.listdir(directory))


def latest_step(directory: str) -> Optional[int]:
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


def _empty(vtype: str):
    """A fresh leaf for an empty value type of ``_METADATA``."""
    return {"None": None, "Dict": {}, "List": [], "Tuple": ()}[vtype]


def _dtype(spec) -> Tuple[np.dtype, bool]:
    """A zarr v2 dtype -> (numpy dtype, is bfloat16)."""
    if spec == "bfloat16":
        return np.dtype("<u2"), True
    if not isinstance(spec, str):
        raise ValueError(f"structured zarr dtype {spec!r} is not supported")
    return np.dtype(spec), False


def _fill(value, dtype: np.dtype, bf16: bool):
    if value is None:
        return 0
    if bf16:
        f = np.array(float(value), np.float32).view(np.uint32)
        return int(f >> 16)  # a bf16 fill value: the float32 top half
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}[value]
    return value


class ZarrArray:
    """One zarr v2 array of a store, by its ``.zarray``."""

    def __init__(self, store, name: str):
        self.store, self.name = store, name
        meta = json.loads(bytes(store.read(f"{name}/.zarray")))
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}"
                             " is not 2")
        if meta.get("filters"):
            raise ValueError(f"{name}: zarr filters are not supported")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        if len(self.chunks) != len(self.shape):
            raise ValueError(f"{name}: chunks {self.chunks} do not match "
                             f"shape {self.shape}")
        self.dtype, self.bf16 = _dtype(meta["dtype"])
        self.order = meta.get("order", "C")
        if self.order not in ("C", "F"):
            raise ValueError(f"{name}: order {self.order!r}")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise ValueError(f"{name}: compressor {comp.get('id')!r} is not "
                             "supported (zstd or none)")
        self.compressed = comp is not None
        self.separator = meta.get("dimension_separator", ".")
        self.fill_value = _fill(meta.get("fill_value"), self.dtype,
                                self.bf16)

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    def _chunk_key(self, idx: Sequence[int]) -> str:
        if not idx:
            return f"{self.name}/0"
        return f"{self.name}/" + self.separator.join(map(str, idx))

    def _decode(self, key: str, out: Optional[np.ndarray] = None
                ) -> np.ndarray:
        """One chunk -> a flat array of the chunk's size (decoded into
        ``out`` where given)."""
        size = math.prod(self.chunks) * self.dtype.itemsize
        raw = self.store.read(key)
        if self.compressed:
            buf = (out.reshape(-1).view(np.uint8) if out is not None
                   else np.empty(size, np.uint8))
            native.zstd_decompress(raw, out=buf)
        else:
            if len(raw) != size:
                raise ValueError(f"{key}: {len(raw)} bytes, the chunk "
                                 f"holds {size}")
            buf = np.frombuffer(raw, dtype=np.uint8)
            if out is not None:
                out.reshape(-1).view(np.uint8)[:] = buf
                buf = out.reshape(-1).view(np.uint8)
        return buf.view(self.dtype)

    def read(self) -> np.ndarray:
        """The whole array, C-contiguous, in its numpy dtype (uint16 for
        bfloat16)."""
        grid = [max(1, -(-s // c)) if c else 1
                for s, c in zip(self.shape, self.chunks)]
        whole = self.chunks == self.shape and self.order == "C"
        out = np.empty(self.shape, self.dtype)
        if whole:
            key = self._chunk_key([0] * len(self.shape))
            if key in self.store:
                self._decode(key, out)
            else:
                out.fill(self.fill_value)
            return out
        for idx in np.ndindex(*grid):
            lo = [i * c for i, c in zip(idx, self.chunks)]
            hi = [min(l + c, s) for l, c, s in zip(lo, self.chunks,
                                                  self.shape)]
            region = tuple(slice(a, b) for a, b in zip(lo, hi))
            key = self._chunk_key(idx)
            if key not in self.store:
                out[region] = self.fill_value
                continue
            chunk = self._decode(key).reshape(self.chunks, order=self.order)
            out[region] = chunk[tuple(slice(0, b - a)
                                      for a, b in zip(lo, hi))]
        return out


def _as_leaf(arr: np.ndarray, bf16: bool):
    if bf16:
        return torch.from_numpy(arr).view(torch.bfloat16)
    return arr


def _build(entries: List[Tuple[List[Tuple[str, int]], Any]]):
    """Nested containers from (key path with key types, leaf) pairs:
    dict keys make dicts, sequence indices make tuples."""
    if len(entries) == 1 and not entries[0][0]:
        return entries[0][1]
    kinds = {path[0][1] for path, _ in entries}
    if len(kinds) != 1:
        raise ValueError("a node mixes dict keys and sequence indices")
    groups: Dict[str, list] = {}
    for path, leaf in entries:
        groups.setdefault(path[0][0], []).append((path[1:], leaf))
    built = {k: _build(v) for k, v in groups.items()}
    if kinds.pop() == 1:
        idx = sorted(int(k) for k in built)
        if idx != list(range(len(idx))):
            raise ValueError(f"sequence indices {idx} are not 0..n-1")
        return tuple(built[str(i)] for i in idx)
    return built


class OrbaxCheckpoint:
    """One step of an Orbax checkpoint directory (the latest where
    ``step`` is None).  ``load_seconds``, ``compressed_bytes`` and
    ``decoded_bytes`` add up the reads of ``state``."""

    def __init__(self, directory: str, step: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        steps = checkpoint_steps(self.directory)
        if step is None:
            if not steps:
                raise FileNotFoundError(
                    f"no finished Orbax checkpoint step in {directory}")
            step = steps[-1]
        elif step not in steps:
            raise FileNotFoundError(f"no step {step} in {directory}")
        self.step = step
        self.path = os.path.join(self.directory, str(step))
        with open(os.path.join(self.path, "meta", "metadata")) as f:
            self.meta = json.load(f)
        state_dir = os.path.join(self.path, "state")
        with open(os.path.join(state_dir, "_METADATA")) as f:
            meta = json.load(f)
        if meta.get("use_zarr3") or not meta.get("use_ocdbt", True):
            raise ValueError(f"{state_dir}: only zarr v2 arrays in an OCDBT "
                             "store (what the JAX package writes) are "
                             "supported")
        self.store = OcdbtStore(state_dir)
        self._leaves: Dict[KeyPath, Tuple[List[Tuple[str, int]], str]] = {}
        for entry in meta["tree_metadata"].values():
            keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
            vtype = entry["value_metadata"]["value_type"]
            if vtype not in _ARRAY_TYPES and vtype not in _EMPTY:
                raise ValueError(f"{state_dir}: leaf "
                                 f"{[k for k, _ in keys]} has value type "
                                 f"{vtype!r}, which is not supported")
            self._leaves[tuple(k for k, _ in keys)] = (keys, vtype)
        self.load_seconds = 0.0
        self.compressed_bytes = 0
        self.decoded_bytes = 0
        self._arrays: Dict[KeyPath, ZarrArray] = {}

    @property
    def config(self) -> Config:
        return Config.from_dict(self.meta["cfg"])

    @property
    def epoch(self) -> int:
        return int(self.meta["epoch"])

    def paths(self) -> List[KeyPath]:
        """Every leaf's key path, arrays and empty leaves."""
        return list(self._leaves)

    def array(self, path: KeyPath) -> ZarrArray:
        if path not in self._arrays:
            if self._leaves[path][1] not in _ARRAY_TYPES:
                raise KeyError(f"{path} holds no array")
            self._arrays[path] = ZarrArray(self.store, ".".join(path))
        return self._arrays[path]

    def shapes(self, select: Optional[Callable[[KeyPath], bool]] = None
               ) -> Dict[str, Tuple[int, ...]]:
        """'/'-joined key path -> shape of every array leaf (from its
        ``.zarray``; nothing is decoded)."""
        return {"/".join(p): self.array(p).shape for p, (_, t) in
                self._leaves.items()
                if t in _ARRAY_TYPES and (select is None or select(p))}

    def read(self, select: Optional[Callable[[KeyPath], bool]] = None
             ) -> Dict[KeyPath, Any]:
        """Key path -> leaf for every leaf ``select`` keeps (all where it
        is None); arrays decode in up to 8 threads."""
        t0 = time.perf_counter()
        chosen = [p for p in self._leaves if select is None or select(p)]
        arrays = [p for p in chosen if self._leaves[p][1] in _ARRAY_TYPES]
        before = self.store.compressed_bytes
        zarrs = [self.array(p) for p in arrays]
        # the largest first, so that one big table does not start last
        order = sorted(range(len(zarrs)), key=lambda i: -zarrs[i].nbytes)
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            done = dict(zip(order, pool.map(lambda i: zarrs[i].read(),
                                            order)))
        out: Dict[KeyPath, Any] = {}
        for i, p in enumerate(arrays):
            out[p] = _as_leaf(done[i], zarrs[i].bf16)
            self.decoded_bytes += done[i].nbytes
        for p in chosen:
            if p not in out:
                out[p] = _empty(self._leaves[p][1])
        self.compressed_bytes += self.store.compressed_bytes - before
        self.load_seconds += time.perf_counter() - t0
        return {p: out[p] for p in chosen}

    def tree(self, select: Optional[Callable[[KeyPath], bool]] = None):
        """The state as nested dicts and tuples of leaves (see ``read``)."""
        leaves = self.read(select)
        if not leaves:
            return {}
        return _build([(self._leaves[p][0], v) for p, v in leaves.items()])


def under(*prefixes: str) -> Callable[[KeyPath], bool]:
    """A ``select`` keeping the leaves under any of the top-level keys."""
    keep = set(prefixes)
    return lambda path: path[0] in keep
