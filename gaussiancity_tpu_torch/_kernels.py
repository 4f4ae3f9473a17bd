# -*- coding: utf-8 -*-
"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (with the shared headers ``csrc/*.cuh``) has a
plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>.so`` at first use,
then loaded with ``ctypes``.  Importing this module needs no ``nvcc``;
only a launch does.  Builds of several sources run as parallel ``nvcc``
processes.  Every exported launcher returns ``cudaGetLastError()`` and
the caller raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("blend_fwd", "blend_bwd", "segment_sum", "raycast",
           "hash_encode_fwd", "hash_encode_bwd", "gather_rowsum", "extrude")
# -fmad=false: no fused multiply-adds, so the kernels round like their
# plain PyTorch versions at the blend and DDA thresholds
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LL = ctypes.c_longlong
_ARGTYPES = {
    # attrs, gauss_index, counts, bg, T, K, n_tx, tile_h, tile_w, sub_h,
    # sub_w, img_h, img_w, origin_x, origin_y, ref_gate, alpha_min,
    # alpha_max, t_eps, scratch, image, final_T, n_contrib, stream
    "blend_fwd": [P, P, P, P, I, I, I, I, I, I, I, I, I, F, F, I, F, F, F,
                  P, P, P, P, P],
    # attrs, gauss_index, k_hi, T, K, n_tx, tile_h, tile_w, sub_h, sub_w,
    # img_h, img_w, origin_x, origin_y, ref_gate, alpha_min, alpha_max,
    # g_out, bg_dot_g, final_T, n_contrib, scratch, grads, stream
    "blend_bwd": [P, P, P, I, I, I, I, I, I, I, I, I, F, F, I, F, F, P, P,
                  P, P, P, P, P],
    # keys, rows, L, M, C, R, out, stream
    "segment_sum": [P, P, I, I, I, I, P, P],
    # volume, occ_words, coarse_cols, coarse2_cols, h, w, d, rays (origin,
    # up, side, fwd), H, W, cy, cx, f, ztop, voxel_id, depth, tile_counter,
    # work (or null), stream
    "raycast": [P, P, P, P, I, I, I, P, I, I, F, F, F, F, P, P, P, P, P],
    # inputs, table, level params, N, D, L, R_max, C, bound, 2 * bound,
    # out, stream
    "hash_encode_fwd": [P, P, P, I, I, I, I, I, F, F, P, P],
    # inputs, table, level params, g, N, D, L, R_max, C, bound, 2 * bound,
    # keys, weights, g_l (or three nulls), part (or null), stream
    "hash_encode_bwd": [P, P, P, P, I, I, I, I, I, F, F, P, P, P, P, P],
    # table, idx, R, M, out, stream
    "gather_rowsum": [P, P, I, LL, P, P],
    # ins, td, bu, pts, map_bytes, h, w, scales (a host array, passed to
    # the kernels by value), n_scales, bldg_min, car_min, facade_sem,
    # car_sem, roof_offset, include_btm, z_cap, sums, n_sums, out (null:
    # pass A), cap, stream
    "extrude": [P, P, P, P, I, I, I, ctypes.POINTER(I), I, I, I, I, I, I,
                I, I, P, LL, P, LL, P],
}

_libs: Dict[str, ctypes.CDLL] = {}
# launches of each kernel's C launcher since the process started, by name
launches: Dict[str, int] = {name: 0 for name in KERNELS}
# per-kernel nvcc output (-Xptxas -v: registers, shared memory, spills)
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _up_to_date(name: str) -> bool:
    """The library is newer than its source and every shared header."""
    lib = library_path(name)
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.exists() and all(lib.stat().st_mtime >= src.stat().st_mtime
                                for src in sources)


def build(names: Optional[Iterable[str]] = None,
          force: bool = False) -> Dict[str, float]:
    """Compile the named kernels (all by default), one ``nvcc`` each, all
    started together.  Returns seconds per kernel built."""
    names = list(names or KERNELS)
    todo = [n for n in names if force or not _up_to_date(n)]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call the kernel's C launcher, count it in ``launches`` and raise
    if the launch failed."""
    lib = load(name)
    code = getattr(lib, name)(*args)
    launches[name] += 1
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"{msg} (error {code})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
