# -*- coding: utf-8 -*-
"""Minimal memcached byte-cache for dataset files (counterpart of
``gaussiancity_tpu/data/memcache.py``).

Stand-in for the reference's SenseTime `mc` client
(reference: utils/io.py:26-101 — `mc_client.Get(file_path, pyvector)` for
png/jpg/pkl/npy reads).  That client is cluster-specific and closed;
this one speaks the standard memcached ASCII protocol (get/set) over a
plain socket, so any stock memcached fleet works.

Differences from the reference, by design:
  - populate-on-miss: a miss falls through to disk and the bytes are
    written back to the cache (the reference assumes an externally
    pre-populated cluster and returns garbage on miss);
  - large values are chunked across keys (stock memcached rejects items
    over its slab limit, default 1 MB; the SenseTime cluster had no such
    limit) — a `<key>` meta entry records chunk count + digest;
  - keys are sha1(path) hex (memcached keys are capped at 250 bytes and
    forbid whitespace; file paths satisfy neither).

Failure policy: any socket/protocol error disables nothing globally —
the read falls back to disk; the connection is re-opened on next use.
"""

from __future__ import annotations

import hashlib
import socket
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_CHUNK = 512 * 1024  # well under memcached's default 1 MB item limit


class MemcachedClient:
    """Thread-safe client over one or more memcached servers.

    Keys are distributed over servers by sha1(key) (static modulo — the
    dataset working set is immutable per run, so consistent hashing buys
    nothing).  One pooled connection per (server, thread).
    """

    def __init__(self, servers: Sequence[str], timeout: float = 2.0):
        if not servers:
            raise ValueError("need at least one 'host:port' server")
        self._addrs: List[Tuple[str, int]] = []
        for s in servers:
            host, _, port = s.rpartition(":")
            self._addrs.append((host, int(port)))
        self._timeout = timeout
        self._local = threading.local()

    # -- connection pool ---------------------------------------------------
    def _sock(self, i: int) -> socket.socket:
        pool: Dict[int, socket.socket] = getattr(self._local, "pool", None)
        if pool is None:
            pool = self._local.pool = {}
        sk = pool.get(i)
        if sk is None:
            sk = socket.create_connection(self._addrs[i], self._timeout)
            sk.settimeout(self._timeout)
            pool[i] = sk
        return sk

    def _drop(self, i: int) -> None:
        pool = getattr(self._local, "pool", {})
        sk = pool.pop(i, None)
        if sk is not None:
            try:
                sk.close()
            except OSError:
                pass

    def _server_for(self, key: str) -> int:
        if len(self._addrs) == 1:
            return 0
        h = int.from_bytes(hashlib.sha1(key.encode()).digest()[:4], "big")
        return h % len(self._addrs)

    # -- raw protocol ------------------------------------------------------
    @staticmethod
    def _recv_line(sk: socket.socket, buf: bytearray) -> bytes:
        while True:
            j = buf.find(b"\r\n")
            if j >= 0:
                line = bytes(buf[:j])
                del buf[: j + 2]
                return line
            chunk = sk.recv(65536)
            if not chunk:
                raise ConnectionError("memcached closed connection")
            buf += chunk

    @staticmethod
    def _recv_n(sk: socket.socket, buf: bytearray, n: int) -> bytes:
        while len(buf) < n:
            chunk = sk.recv(65536)
            if not chunk:
                raise ConnectionError("memcached closed connection")
            buf += chunk
        out = bytes(buf[:n])
        del buf[:n]
        return out

    def _get_raw(self, key: str) -> Optional[bytes]:
        i = self._server_for(key)
        try:
            sk = self._sock(i)
            sk.sendall(b"get " + key.encode() + b"\r\n")
            buf = bytearray()
            value = None
            while True:
                line = self._recv_line(sk, buf)
                if line == b"END":
                    return value
                if line.startswith(b"VALUE "):
                    nbytes = int(line.split()[3])
                    value = self._recv_n(sk, buf, nbytes)
                    self._recv_n(sk, buf, 2)  # trailing \r\n
                else:
                    raise ConnectionError(f"unexpected reply: {line!r}")
        except (OSError, ConnectionError, ValueError, IndexError):
            self._drop(i)
            return None

    def _set_raw(self, key: str, value: bytes) -> bool:
        i = self._server_for(key)
        try:
            sk = self._sock(i)
            hdr = f"set {key} 0 0 {len(value)}\r\n".encode()
            sk.sendall(hdr + value + b"\r\n")
            buf = bytearray()
            return self._recv_line(sk, buf) == b"STORED"
        except (OSError, ConnectionError):
            self._drop(i)
            return False

    # -- chunked file API --------------------------------------------------
    @staticmethod
    def _key(path: str) -> str:
        return "gc:" + hashlib.sha1(path.encode()).hexdigest()

    def get_file(self, path: str) -> Optional[bytes]:
        """Cached bytes of `path`, or None on miss/any error."""
        base = self._key(path)
        meta = self._get_raw(base)
        if meta is None:
            return None
        try:
            n_chunks, total, digest = meta.decode().split(",")
            n_chunks, total = int(n_chunks), int(total)
        except (UnicodeDecodeError, ValueError):
            return None
        parts = []
        for c in range(n_chunks):
            p = self._get_raw(f"{base}:{c}")
            if p is None:  # partial eviction
                return None
            parts.append(p)
        blob = b"".join(parts)
        if len(blob) != total or \
                hashlib.sha1(blob).hexdigest()[:16] != digest:
            return None
        return blob

    def set_file(self, path: str, blob: bytes) -> bool:
        base = self._key(path)
        chunks = [blob[o:o + _CHUNK] for o in range(0, len(blob), _CHUNK)] \
            or [b""]
        # chunks first, meta last: a concurrent reader never sees meta
        # pointing at missing chunks
        for c, part in enumerate(chunks):
            if not self._set_raw(f"{base}:{c}", part):
                return False
        meta = f"{len(chunks)},{len(blob)}," \
               f"{hashlib.sha1(blob).hexdigest()[:16]}"
        return self._set_raw(base, meta.encode())
