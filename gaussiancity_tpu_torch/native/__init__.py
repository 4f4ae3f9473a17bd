# -*- coding: utf-8 -*-
"""Host code in C++, driven through ctypes: the footprint extruder
(counterpart of ``gaussiancity_tpu/native``) and the zstd decoder with
CRC32C that reads the JAX package's Orbax checkpoints.

Each source is compiled with g++ at first use into ``_build/`` and cached
by source mtime; without a compiler the call raises ``NativeUnavailable``.
The extruder is the host counterpart of kernel E1 (``ops.extrusion``),
which the dataset path uses; nothing in the port falls back to it.
``zstd_decode.cpp`` is written from RFC 8878 and links no zstd library;
nothing falls back from it either.  ctypes releases the GIL for the
length of each call, so threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_THIS_DIR, "_build")
_LIB: Optional[ctypes.CDLL] = None
_ZSTD: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _build_lib(source: str = "footprint_extruder.cpp",
               name: str = "libgct_native.so",
               flags: Sequence[str] = ("-fopenmp",)) -> str:
    src = os.path.join(_THIS_DIR, source)
    out = os.path.join(_BUILD_DIR, name)
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    # each build writes its own file and renames it into place, so that
    # processes building at once never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", *flags, "-std=c++17",
           src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", b"")
        raise NativeUnavailable(
            f"failed to build {source}: {e}\n"
            f"{detail.decode() if detail else ''}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build_lib())
        lib.gct_extrude_points.restype = ctypes.c_int64
        lib.gct_extrude_points.argtypes = [
            ctypes.POINTER(ctypes.c_int16),  # ins
            ctypes.POINTER(ctypes.c_int16),  # td
            ctypes.POINTER(ctypes.c_int16),  # bu
            ctypes.POINTER(ctypes.c_uint8),  # pts_map
            ctypes.c_int32, ctypes.c_int32,  # h, w
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int32,  # scales
            ctypes.c_int16, ctypes.c_int16,  # bldg_min, car_min
            ctypes.c_int16, ctypes.c_int16, ctypes.c_int16,  # sems, roof
            ctypes.c_int32,  # include_btm
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,  # out, max_out
            ctypes.c_int32,  # n_threads
        ]
        _LIB = lib
    return _LIB


def extrude_points_native(
    ins_map: np.ndarray,
    td_hf: np.ndarray,
    bu_hf: np.ndarray,
    pts_map: np.ndarray,
    rel,  # ops.extrusion.SegInsRelation
    class_scales: Sequence[int],
    include_btm_pts: bool = True,
    n_threads: int = 0,
) -> np.ndarray:
    """Native mirror of ops.extrusion.extrude_points_np — [N, 5] int32
    (x, y, z, scale, instance)."""
    lib = _lib()
    H, W = ins_map.shape
    ins = np.ascontiguousarray(ins_map, dtype=np.int16)
    td = np.ascontiguousarray(td_hf, dtype=np.int16)
    bu = np.ascontiguousarray(bu_hf, dtype=np.int16)
    ptsm = np.ascontiguousarray(pts_map, dtype=np.uint8)
    scales = np.ascontiguousarray(class_scales, dtype=np.int16)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    def call(out, cap):
        return lib.gct_extrude_points(
            ptr(ins, ctypes.c_int16), ptr(td, ctypes.c_int16),
            ptr(bu, ctypes.c_int16), ptr(ptsm, ctypes.c_uint8),
            H, W, ptr(scales, ctypes.c_int16), len(scales),
            rel.bldg_ins_min_id, rel.car_ins_min_id,
            rel.bldg_facade_semantic_id, rel.car_semantic_id,
            rel.roof_ins_offset, int(include_btm_pts),
            ptr(out, ctypes.c_int32), cap, n_threads,
        )

    # generous first guess: top+bottom per masked pixel + borders
    cap = max(int(ptsm.sum()) * 4, 1024)
    out = np.empty((cap, 5), dtype=np.int32)
    n = call(out, cap)
    if n > cap:
        out = np.empty((n, 5), dtype=np.int32)
        n = call(out, n)
    return out[:n].copy()


# ---------------------------------------------------------------------------
# zstd and CRC32C
# ---------------------------------------------------------------------------

def _zstd() -> ctypes.CDLL:
    global _ZSTD
    if _ZSTD is None:
        lib = ctypes.CDLL(_build_lib("zstd_decode.cpp", "libgct_zstd.so",
                                     flags=()))
        err = [ctypes.c_char_p, ctypes.c_size_t,
               ctypes.POINTER(ctypes.c_int64)]
        lib.gct_zstd_decompress.restype = ctypes.c_int64
        lib.gct_zstd_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, *err]
        lib.gct_zstd_decompress_alloc.restype = ctypes.c_int64
        lib.gct_zstd_decompress_alloc.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), *err]
        lib.gct_free.restype = None
        lib.gct_free.argtypes = [ctypes.c_void_p]
        lib.gct_crc32c.restype = ctypes.c_uint32
        lib.gct_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        _ZSTD = lib
    return _ZSTD


def _bytes_view(data) -> np.ndarray:
    """bytes, a memoryview or an array (a memmap too) as contiguous uint8
    without a copy where it already is contiguous."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, dtype=np.uint8)


def zstd_decompress(data, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode the zstd frames of ``data`` -> uint8 array.

    ``out``, a writable C-contiguous array, receives the decoded bytes;
    its size is the one the caller declares, and a stream that decodes to
    any other size raises.  Without ``out`` the library sizes the buffer.
    Malformed input raises ``ValueError`` naming the byte offset; no
    partial output is returned."""
    lib = _zstd()
    src = _bytes_view(data)
    msg = ctypes.create_string_buffer(256)
    where = ctypes.c_int64(0)
    if out is not None:
        if not (out.flags.c_contiguous and out.flags.writeable):
            raise ValueError("out must be a writable C-contiguous array")
        dst = out.reshape(-1).view(np.uint8)
        n = lib.gct_zstd_decompress(src.ctypes.data, src.size,
                                    dst.ctypes.data, dst.size, msg,
                                    len(msg), ctypes.byref(where))
        if n < 0:
            raise ValueError(f"zstd: {msg.value.decode()} at byte "
                             f"{where.value}")
        if n != dst.size:
            raise ValueError(f"zstd: decoded {n} bytes where {dst.size} "
                             "were declared")
        return out
    ptr = ctypes.c_void_p()
    n = lib.gct_zstd_decompress_alloc(src.ctypes.data, src.size,
                                      ctypes.byref(ptr), msg, len(msg),
                                      ctypes.byref(where))
    if n < 0:
        raise ValueError(f"zstd: {msg.value.decode()} at byte {where.value}")
    try:
        result = np.empty(n, dtype=np.uint8)
        ctypes.memmove(result.ctypes.data, ptr, n)
    finally:
        lib.gct_free(ptr)
    return result


def crc32c(data) -> int:
    """CRC32C (Castagnoli) of ``data``."""
    src = _bytes_view(data)
    return int(_zstd().gct_crc32c(src.ctypes.data, src.size))
