# -*- coding: utf-8 -*-
"""A read-only OCDBT key-value store: the format in which Orbax (through
TensorStore's ``ocdbt`` driver) writes the arrays of a JAX checkpoint.

An OCDBT directory holds ``manifest.ocdbt`` and data files under ``d/``.
Every manifest and B-tree node is framed the same way:

    magic (u32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de B-tree node)
    length of the whole frame (u64 little-endian)
    version (varint), compression (varint: 0 none, 1 zstd)
    body (a zstd frame when compressed)
    CRC32C of everything before it (u32 little-endian)

The manifest's body is the store's config (uuid, manifest kind, inline
and node size limits, the version tree's arity, the compression and
three data-file prefixes), then the inline version tree: a data-file
table and the latest versions, each with its B-tree root (height, file,
offset, length) and statistics, and references to older version-tree
nodes.  A B-tree node is its height, a data-file table and its entries,
column by column: keys prefix-compressed against the previous key, then
for a leaf each value's length, kind (inline or by reference) and, for
the referenced ones, (file, offset); for an interior node each child's
common key prefix (between the key lengths and the key bytes), location
and statistics.  A data-file table lists
paths prefix-compressed against the previous one, each split into a base
path and a relative path; both together name the file from the store's
directory.

``OcdbtStore(path)`` walks the tree of the latest version once;
``list()`` gives the keys in order and ``read(key)`` a memoryview of the
value, taken from a ``np.memmap`` of its data file where it is stored by
reference.  Decoding is ``native.zstd_decompress``, checksums
``native.crc32c``.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from gaussiancity_tpu_torch import native

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_MAX_VERSION = 0

# a value: the bytes themselves, or (data file path, offset, length)
_Value = Union[bytes, Tuple[str, int, int]]


class _Cursor:
    """Little-endian varints, bytes and fixed-width integers of a body."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.what}: truncated at byte {self.pos}")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            self._need(1)
            b = self.buf[self.pos]
            self.pos += 1
            if shift >= 64:
                raise ValueError(f"{self.what}: varint too long at byte "
                                 f"{self.pos}")
            value |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.buf[self.pos - 1]

    def u64s(self, n: int) -> List[int]:
        self._need(8 * n)
        out = list(struct.unpack_from(f"<{n}Q", self.buf, self.pos))
        self.pos += 8 * n
        return out

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise ValueError(f"{self.what}: {len(self.buf) - self.pos} "
                             "bytes after the end of its body")


def decode_frame(data: bytes, magic: int, what: str) -> bytes:
    """Check one framed file (magic, length, version, compression, CRC32C)
    and return its decoded body."""
    if len(data) < 4 + 8 + 2 + 4:
        raise ValueError(f"{what}: {len(data)} bytes is too short")
    (got_magic,) = struct.unpack_from(">I", data, 0)
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x}, expected "
                         f"{magic:#010x}")
    (length,) = struct.unpack_from("<Q", data, 4)
    if length != len(data):
        raise ValueError(f"{what}: header says {length} bytes, the file "
                         f"holds {len(data)}")
    (crc,) = struct.unpack_from("<I", data, len(data) - 4)
    want = native.crc32c(memoryview(data)[:len(data) - 4])
    if crc != want:
        raise ValueError(f"{what}: CRC32C {crc:#010x} does not match the "
                         f"content's {want:#010x}")
    head = _Cursor(data[:len(data) - 4], what)
    head.pos = 12
    version = head.varint()
    if version > _MAX_VERSION:
        raise ValueError(f"{what}: format version {version} is not "
                         "supported")
    compression = head.varint()
    body = data[head.pos:len(data) - 4]
    if compression == 0:
        return bytes(body)
    if compression == 1:
        return native.zstd_decompress(body).tobytes()
    raise ValueError(f"{what}: unknown compression {compression}")


def _data_file_table(c: _Cursor) -> List[str]:
    """Paths of a data-file table, base path + relative path each."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    base = c.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: data-file path prefix too long")
        path = prev[:prefix[i]] + c.take(suffix[i])
        if base[i] > len(path):
            raise ValueError(f"{c.what}: data-file base path too long")
        name = path.decode()
        # the paths come from the checkpoint: none may leave its directory
        if os.path.isabs(name) or ".." in name.split("/"):
            raise ValueError(f"{c.what}: data-file path {name!r} lies "
                             "outside the store's directory")
        paths.append(name)
        prev = path
    return paths


def _keys(c: _Cursor, n: int, interior: bool
          ) -> Tuple[List[bytes], List[int]]:
    """The keys of a node's n entries, and for an interior node each
    child's common key prefix length (its column lies between the key
    lengths and the key bytes)."""
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: key prefix longer than its "
                             "predecessor")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        keys.append(prev)
    return keys, common


def _check_file(paths: List[str], i: int, what: str) -> str:
    if i >= len(paths):
        raise ValueError(f"{what}: data file {i} of a table of "
                         f"{len(paths)}")
    return paths[i]


class OcdbtStore:
    """The latest version of the OCDBT store in directory ``path``."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        manifest = os.path.join(self.path, "manifest.ocdbt")
        with open(manifest, "rb") as f:
            body = decode_frame(f.read(), MANIFEST_MAGIC, manifest)
        c = _Cursor(body, manifest)
        self.config = self._config(c)
        root = self._version_tree(c)
        c.done()
        self._values: Dict[bytes, _Value] = {}
        self._maps: Dict[str, np.memmap] = {}
        self._lock = threading.Lock()  # reads come from several threads
        self.compressed_bytes = 0  # bytes of the nodes and values read
        if root is not None:
            self._walk(b"", *root)

    @staticmethod
    def _config(c: _Cursor) -> dict:
        cfg = {"uuid": c.take(16).hex(), "manifest_kind": c.varint(),
               "max_inline_value_bytes": c.varint(),
               "max_decoded_node_bytes": c.varint(),
               "version_tree_arity_log2": c.u8()}
        method = c.varint()
        if method == 1:
            cfg["compression"] = {"id": "zstd", "level": c.varint()}
        elif method == 0:
            cfg["compression"] = None
        else:
            raise ValueError(f"{c.what}: unknown compression method "
                             f"{method}")
        cfg["data_file_prefixes"] = [c.take(c.varint()).decode()
                                     for _ in range(3)]
        if cfg["manifest_kind"] != 0:
            raise ValueError(f"{c.what}: manifest kind "
                             f"{cfg['manifest_kind']} (numbered manifests) "
                             "is not supported")
        return cfg

    @staticmethod
    def _version_tree(c: _Cursor) -> Optional[Tuple[int, str, int, int]]:
        """The inline version tree -> the latest root (height, file,
        offset, length), or None for an empty store."""
        files = _data_file_table(c)
        n = c.varint()
        generation = c.varints(n)
        height = [c.u8() for _ in range(n)]
        file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_bytes
        c.u64s(n)  # commit times
        # older versions live in version-tree nodes; the latest is inline
        m = c.varint()
        c.varints(m)  # generation numbers
        c.varints(3 * m)  # file, offset, length
        c.varints(m)  # generations per node
        c.u64s(m)  # commit times
        for _ in range(m):
            c.u8()  # heights
        if n == 0:
            if m:
                raise ValueError(f"{c.what}: version-tree nodes without an "
                                 "inline version")
            return None
        last = int(np.argmax(generation))
        if last != n - 1:
            raise ValueError(f"{c.what}: versions are out of order")
        if length[last] == 0:
            return None
        return (height[last], _check_file(files, file_id[last], c.what),
                offset[last], length[last])

    def _read_file(self, rel: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.path, rel), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{rel}: {length} bytes at {offset} run past "
                             "the end of the file")
        self.compressed_bytes += length
        return data

    def _walk(self, prefix: bytes, height: int, rel: str, offset: int,
              length: int) -> None:
        what = f"B-tree node {rel}@{offset}"
        body = decode_frame(self._read_file(rel, offset, length),
                            BTREE_MAGIC, what)
        c = _Cursor(body, what)
        got_height = c.u8()
        if got_height != height:
            raise ValueError(f"{what}: height {got_height}, its parent "
                             f"says {height}")
        files = _data_file_table(c)
        n = c.varint()
        keys, common = _keys(c, n, height > 0)
        if height == 0:
            lengths = c.varints(n)
            kinds = c.varints(n)
            if any(k > 1 for k in kinds):
                raise ValueError(f"{what}: unknown value kind")
            refs = [i for i in range(n) if kinds[i] == 1]
            ref_file, ref_off = c.varints(len(refs)), c.varints(len(refs))
            for i, f, o in zip(refs, ref_file, ref_off):
                self._values[prefix + keys[i]] = (
                    _check_file(files, f, what), o, lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    self._values[prefix + keys[i]] = c.take(lengths[i])
            c.done()
            return
        child_file, child_off, child_len = (c.varints(n), c.varints(n),
                                            c.varints(n))
        c.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_bytes
        c.done()
        for i in range(n):
            if common[i] > len(keys[i]):
                raise ValueError(f"{what}: subtree prefix longer than its "
                                 "key")
            self._walk(prefix + keys[i][:common[i]], height - 1,
                       _check_file(files, child_file[i], what),
                       child_off[i], child_len[i])

    def list(self) -> List[str]:
        """Every key, in order."""
        return [k.decode() for k in sorted(self._values)]

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str) -> memoryview:
        """The value of ``key``; KeyError where it is absent."""
        v = self._values[key.encode()]
        if isinstance(v, bytes):
            with self._lock:
                self.compressed_bytes += len(v)
            return memoryview(v)
        rel, offset, length = v
        with self._lock:
            self.compressed_bytes += length
            mm = self._maps.get(rel)
            if mm is None:
                full = os.path.join(self.path, rel)
                mm = (np.memmap(full, dtype=np.uint8, mode="r")
                      if os.path.getsize(full) else np.zeros(0, np.uint8))
                self._maps[rel] = mm
        if offset + length > mm.size:
            raise ValueError(f"{rel}: value of {key!r} ({length} bytes at "
                             f"{offset}) runs past the end of the file")
        return memoryview(mm[offset:offset + length])
