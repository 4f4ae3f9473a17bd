# -*- coding: utf-8 -*-
"""The host extruder in C++ (counterpart of ``gaussiancity_tpu/native``),
driven through ctypes.

``footprint_extruder.cpp`` is compiled with g++ at first use into
``_build/`` and cached by source mtime; without a compiler the call
raises ``NativeUnavailable``.  It is the host counterpart of kernel E1
(``ops.extrusion``), which the dataset path uses; nothing in the port
falls back to it.
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


class NativeUnavailable(RuntimeError):
    pass


def _build_lib() -> str:
    src = os.path.join(_THIS_DIR, "footprint_extruder.cpp")
    out = os.path.join(_BUILD_DIR, "libgct_native.so")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17",
           src, "-o", out]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", b"")
        raise NativeUnavailable(
            f"failed to build native extruder: {e}\n"
            f"{detail.decode() if detail else ''}")
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
