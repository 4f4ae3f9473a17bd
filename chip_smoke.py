#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``gaussiancity_tpu_torch``) on one
NVIDIA card.

Phases, each of which fails the run if it fails:

1. build every hand-written kernel of ``gaussiancity_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all started together);
2. print the card's name and power limit, and turn TF32 off;
3. hold the blend forward (K1) against its plain PyTorch version at the
   frame's shape (960x540 at 32x32 tiles: 510 tiles, 2048 slots, the
   16x16 reference gate on), on a seeded scene, and count the work the
   function needs for its bound (``blend.blend_work``);
4. hold the first-hit raycast (V1), with the occupancy tables that
   ``build_volume`` caches, against its plain version on the synthetic
   city's 512x512x192 id volume at 960x540: voxel ids and depths
   bit-equal on every ray;
5. render a small trajectory on the card and on the CPU (plain versions)
   and compare the frames;
6. render a REST inference trajectory at the REST recipe's full widths
   through ``InferencePipeline.render_trajectory`` (warm-up pass, then a
   timed pass with the kernels' launch counts set to 0 just before it),
   and check that every frame has content and went through K1 and V1;
7. hold the blend backward (K2: its live rows, the first ``sum(k_hi)``)
   and the sorted segment sum (K3, both of its uses: the hash-grid
   embedding gradient and the per-Gaussian gradient reduction) against
   their plain versions on the inputs one full-width REST train step
   gives them, run K2 and K3 twice (bit-equal), and fail if K3 is slower
   than ``index_add_`` in either use;
8. take two train steps of a tiny config on the card and on the CPU
   (plain versions) from the same seeded weights and compare losses and
   gradients;
9. train the REST generator at the REST recipe's full widths through
   ``Trainer.train_step`` (2 warm-up steps, then 5 timed steps with the
   launch counts set to 0 just before them): finite losses, changed
   weights, ``RasterGradTruncated`` 0, and K1, K2, K3 (both uses), G1 and
   G1b on every step; then the backward stage with the hash-grid backward
   on G1b and on its plain version in turns;
10. render a small REST + BLDG (PTv3) trajectory on the compact path on
    the card and on the CPU and compare the frames;
11. render the two-model frame at full widths (REST recipe seed 0, BLDG
    recipe seed 1, budgets REST 196,608 and BLDG 65,536, the style table
    of the BLDG model's width) through ``render_trajectory`` (warm-up
    pass, whose first frame's hash-grid inputs are kept, then a timed pass
    with the launch counts set to 0): content, a non-empty BLDG bucket and
    K1, V1 and G1 on every frame, the stage split per model;
12. hold the hash-grid forward (G1) against its plain version on each of
    its three uses: the first REST frame's points, the REST bucket of the
    two-model frame and the train step's 16,384 points (checked right
    after the capture, before the timed train steps), twice (bit-equal);
    hold its backward (G1b) against its plain version on the train step's
    captured backward inputs (keys, weights and g_l bit-equal, the input
    gradient within G1B_RTOL, bit-equal on a repeat), and count the
    hash-grid backward's device launches per step on the plain path and
    on G1b (torch.profiler);
13. take two tiny BLDG train steps (PTv3 in training mode, drop path 0,
    one z table) on the card and on the CPU from the same seeded weights
    and compare losses, gradients and PTv3's running statistics;
14. train the BLDG generator at the BLDG recipe's widths through
    ``Trainer.train_step`` on 16,384 shell points of the synthetic city's
    largest building: one step whose K1, K2 and K3 (per Gaussian) inputs
    are kept and held against the plain versions, 2 warm-up steps, then 5
    timed steps with the launch counts set to 0 just before them: finite
    losses, changed weights and running statistics, ``RasterGradTruncated``
    and ``PTv3PoolOverflow`` 0, K1, K2 and K3 on every step, the stage
    split with PTv3 apart, the peak memory; then one eval step that leaves
    the running statistics as they are;
15. run the training loop ``train()`` on the card over the synthetic
    dataset with a tiny BLDG config: one epoch with validation and a
    checkpoint, then a resume from it for the second; steps per second;
16. generate a dataset city on the card: the synthetic city's maps
    written as projection PNGs, 8 orbit poses, ``generate_city`` at the
    JAX default 640 x 640 x 256 volume (the footprint extrusion E1 once a
    category a view, V1 once a view, the split of a view's time), view 0
    again on the CPU by the plain path (its maps, points and instance map
    bit-equal to the card's files), footage JPEGs and one
    ``GoogleEarthDataset`` item read back; E1 held against its plain
    version and timed on view 0's maps, V1 on its volume;
17. run the command line (``python3 -m gaussiancity_tpu_torch``) as
    subprocesses on the card: train mode, 4 steps of the tiny REST widths
    on that city (a checkpoint, finite losses, overflow counters 0), then
    ``--test`` on its checkpoint;
18. run the command line's ``--inference`` from the checkpoints of the
    full-width REST and BLDG trainers of phases 9 and 14 over that city,
    8 frames: the video and the jpgs written, the jpgs byte-equal to an
    in-process ``InferencePipeline`` from ``get_models`` of the same
    directories (same poses, style table and budgets), K1, V1 and G1 on
    every in-process frame; the CLI's time split and peak memory; then
    K1, V1 and G1 held against their plain versions on the arguments the
    first in-process frame gives them.  Every
    file of phases 16-18 lives under ``output/chip_smoke_cli``, removed
    at the end;
19. drive the row-gather probe (K4) at its shape, count set to 0 just
    before, and hold K4 against its plain version (bit-equal, and on a
    repeat);
20. the model-surface options at tiny widths, card against CPU: a bf16
    REST step and a bf16 BLDG step at batch size 2 (within the bf16 noise
    that the CPU's float32 steps measure, the first step's generator loss
    within a quarter of it; as a control, the card's float32 steps must
    break one of these limits), a LOCAL REST step, the small PTv3 with
    ``enable_rpe`` and with the sorted-merge neighbour search,
    ``naive_render`` against ``rasterize`` (K1 within 1e-5) and
    ``rasterize_checked`` on a NaN colour (snapshot and raise) and on a
    NaN mean (culled);
21. the full-width REST step in bf16 (``network`` and ``train``
    ``compute_dtype``) on phase 9's batch: K1, K2, K3, G1 and G1b held
    against their plain versions on one step's inputs, then 2 warm-up and
    5 timed steps with the counts set to 0 just before them, the stage
    split and peak beside phase 9's float32 step;
22. the full-width BLDG step at batch size 2 (building 172 and the next
    largest, 16,384 rows each with the point mask), in float32 and in
    bf16: K1, K2 and K3 held on one step's inputs, 2 + 5 steps, PTv3
    apart, peak memory, an eval step (``--profile``: the device's busy
    share);
23. the full-width REST step with the LOCAL encoder on phase 9's batch
    with the city's projection maps: G1, G1b (with the input gradient)
    and K3 held against their plain versions on one step's inputs and
    timed, then 2 + 5 steps;
24. PTv3 at the BLDG recipe's widths in eval on phase 14's 16,384
    points: the sorted-merge neighbours equal to the dense ones at every
    search, both searches timed, the forward with each (outputs equal)
    and with ``enable_rpe`` timed, with its peak memory;
25. the two-model frame with both generators in bf16 (phase 11's
    weights, scene and poses): its median beside phase 11's, the
    per-pixel grey-level difference from phase 11's frames (within 1 at
    >= 99 % of pixels, and unequal at >= 1 %), and K1 held against its
    plain version on the first frame's inputs;
26. NCCL at world size 1 on the card (one spawned rank): a tiny REST and
    a tiny BLDG data-parallel step (``make_parallel_train_step``) equal
    ``Trainer.train_step`` of a twin trainer bit for bit over two steps
    (losses, every gradient, the weights after Adam), PyTorch's
    deterministic algorithms on;
27. two ranks sharing the card (gloo) against two ranks on the CPU (gloo,
    plain versions): two tiny REST and two tiny BLDG steps, a different
    sample a rank (phases 8 and 13's limits; the replicas bit-equal after
    every step; the ranks' z tables differ);
28. the full-width data-parallel REST step (phase 9's batch on rank 0,
    another draw and crop on rank 1) and BLDG step (buildings 172 and 168,
    phase 22's samples), two ranks on the card: rank 0's first-step K1,
    K2 and K3 (and G1, G1b on REST) held against their plain versions,
    then 2 warm-up and 5 timed steps: median, stage split (the
    collectives as ``allreduce``) and peak per rank, the replicas
    bit-equal after every step, finite losses, the exactness counters 0,
    the kernels on every step of every rank;
29. band-sharded rendering on two ranks: phase 6's first-pose Gaussians
    through ``make_sharded_rasterizer`` at 960x540 (two bands of 288
    rows, 36 cropped) against the single-device ``rasterize`` (image
    within 1e-5) and its backward (a sum-of-squares loss, within 1e-4 of
    each column's scale), K1 and K2 on each band and held on band 0's
    inputs; phase 11's frames through ``make_sharded_frame`` (phase 11's
    weights, buckets, poses and style table): within 1 grey level of
    phase 11's frames at >= 99 % of pixels, its median beside phase 11's
    stages, K1 and G1 held on rank 0's first frame;
30. the command line on two processes sharing the card (``--coordinator
    127.0.0.1:<port> --num-processes 2 --process-id {0,1}``), 4 steps of
    the tiny REST widths on phase 16's city: one checkpoint, by rank 0,
    both ranks' replica digests equal to it, counters 0, then ``--test``;
31. from raw capture to training city on the card: a synthetic Google
    Earth capture at the real width (a 2560-pixel OSM render with roads,
    water and 320 buildings, its metadata, an .esp project, a camera path
    and the capture's metadata, written here) through the port's
    ``process_city`` (``google_earth_projections`` at MAP_SIZE 2048, the
    poses, 4 views at 640 x 640 x 256: E1 once a view, the view's stage
    split); E1 held against its plain version on the 2048-pixel REST map
    (bit-equal, and on a repeat) and timed beside the host extruders
    (NumPy and g++, wall clock, the same rows), one ``GoogleEarthDataset``
    item read back; then a small KITTI-360 drive (3D-box XML, two
    categories a view, 256 x 256 x 128) through ``process_city`` on the
    card and on the CPU: Points pkls and instance images equal.

Two ranks on one card measure correctness and each rank's path (its
kernels, its collectives staged through the host by gloo), not NVLink
scaling.  The ranks are spawned processes (``parallel.launch``) that load
the kernels phase 1 built; each is joined with a timeout.

The perceptual loss runs on seeded random VGG19 weights (the repository
holds no converted ImageNet weights) behind the JAX package's opt-in gate,
and the run says so.

It prints timings beside the card's name and power limit, a ``kernels``
JSON line (launches on the timed passes, time, plain time, library time,
bound, max error; K1 and K2 also the pairs their bounds count and the
bound over every tested pair as ``tested_bound_ms``; K3 and G1 also per
use; K1, K2 and K3 also their use on the BLDG step, under "uses" as
"bldg_step"; V1 also its use on a generated dataset view, under "uses"
as "dataset_view"; K1, V1 and G1 also their use on the CLI's inference
frame, under "uses" as "cli_frame"; G1b also the backward's launches
per step and the A/B of phase 9; the uses of phases 21-23 under
"rest_step_bf16", "bldg_step_b2_f32", "bldg_step_b2_bf16" and
"local_step", K3's with its kind appended; K1's on phase 25's frame as
"bf16_frame"; the uses of phases 28-29 under "ddp_rest_step",
"ddp_bldg_step", "sharded_raster" and "sharded_frame"; E1's on phase
16's dataset view and phase 31's 2048-pixel map as "dataset_view" and
"ge_2048", with the rows each emitted), and as its last
line
``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``
(``--profile`` adds passes over the frames and the train steps under
the port's ``utils.profiling.trace``: device time by kernel, the busy
share, and Chrome traces under ``output/chip_smoke_cli/traces``, removed
at the end).  Without a CUDA device, or outside the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import time
from typing import List, Tuple

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor)
# FLOP/s, used for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# fp32 operations of the blend forward per (pixel, slot) pair tested where
# the 16x16 gate holds: offsets (2), power (9), one test against the
# lower of 0 and the slot's alpha floor (1), which settles the pairs that
# cannot reach alpha_min
BLEND_FLOP_PER_GATED = 12
# and per eligible pair (power <= 0, alpha >= alpha_min): exp (1), alpha
# and clamp (2), the alpha test (1), transmittance and its test (3),
# weight (1), colour (6)
BLEND_FLOP_PER_ELIGIBLE = 14
# per tested pair, gate or not, as if every pair blended (the bound over
# every tested pair, ``tested_bound_ms``): the two above and the three
# eligibility tests
BLEND_FLOP_PER_EVAL = 26
# operations per DDA step: axis choice (2), cell step and exit test (3),
# next crossing (3), in-volume test (6), voxel address (4), hit test (1)
RAYCAST_OPS_PER_STEP = 19
# operations per jump over an empty region (csrc/raycast.cu jump_empty):
# the region's bounds (20), three axes' exit crossings (24), the exit axis
# (6), two searches of up to five probes of ~9 operations (90), the new
# cells and crossings (20)
RAYCAST_OPS_PER_JUMP = 160
# fp32 operations of the blend backward per (pixel, slot) pair tested
# where the 16x16 gate holds: offsets (2), power (9), the tests of
# slot < n_contrib and against the lower of 0 and the alpha floor (2)
BLEND_BWD_FLOP_PER_GATED = 13
# and per counted pair: exp (1), alpha and clamp (2), the alpha test (1),
# T / (1 - alpha) (2), the colour recurrence (12), weight and colour
# gradients (4), dL/dalpha (12), dL/dG, G dx, G dy (3), the six geometry
# and opacity gradients (17), the nine reduction adds (9)
BLEND_BWD_FLOP_PER_COUNTED = 63
# per tested pair, gate or not (``tested_bound_ms``, which charges no
# counted pair more): offsets (2), power (9), exp (1), alpha and clamp
# (2), the eligibility tests (3) and the nine reduction adds (9)
BLEND_BWD_FLOP_PER_EVAL = 26
# operations of one (sub-tile, slot) cull test: the four getRect block
# bounds (12) and the four overlap tests (4)
BLEND_CULL_OPS = 16

K1_TOL = 1e-5  # image and final_T, max abs
# K2: per-pixel terms equal the plain version's, the sums over a tile's
# 1,024 pixels run in another order: relative to each column's largest
# magnitude
K2_RTOL = 1e-4
# K3 sums each run in sorted order, the plain index_add_ in its own:
# relative to the largest output magnitude
K3_RTOL = 1e-5
# tiny train step, card vs CPU: convolutions (cuDNN, TF32 off) and
# reductions sum in other orders; gradients relative to each parameter's
# largest gradient
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
# G1: per-corner terms equal the plain version's, only the order of the
# sum over the 2^D corners differs: relative to the largest output (K4 is
# held bit-equal: bf16 -> float32 is exact and both add in channel order)
G1_RTOL = 1e-6
# G1b: keys, weights and g_l equal the plain version's bit for bit, and so
# does each corner's term of the input gradient; its sums over channels,
# 2^D corners and L levels run in another order: relative to the largest
# input gradient
G1B_RTOL = 1e-5
# the JAX package's two-model frame (bench.py:373-417)
FRAME_BUDGETS = {"REST": 196608, "BLDG": 65536}
TRAIN_POINTS = 16384  # the REST recipe's train_max_points
MATCH_SHARE = 0.999  # K1 n_contrib: share of pixels equal
N_BLEND_GAUSSIANS = 400_000  # Gaussians of K1's seeded test scene


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card over ``iters`` runs (CUDA events,
    after ``warmup`` runs).  The runs are queued behind a ~5 ms device
    sleep, so that a kernel shorter than its host-side launch is timed on
    the device and not at the host's launch rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def synthetic_city(P: int = 512, n_buildings: int = 48, seed: int = 0):
    """Roads and a random grid of box buildings (the benchmark city of the
    JAX package's bench.py): REST projections and instance centres."""
    rng = np.random.default_rng(seed)
    ins = np.ones((P, P), np.int16)
    td = np.full((P, P), 2, np.int16)
    for bi in range(n_buildings):
        x, y = rng.integers(16, P - 48, 2)
        w, h = rng.integers(12, 40, 2)
        ins[y:y + h, x:x + w] = 100 + 2 * bi
        td[y:y + h, x:x + w] = rng.integers(20, 120)
    seg = np.where(ins >= 100, 2, ins).astype(np.int16)
    projections = {"REST": {
        "INS": ins, "SEG": seg, "TD_HF": td,
        "BU_HF": np.zeros((P, P), np.int16), "PTS": np.ones((P, P), bool)}}
    centers = {}
    for iid in np.unique(ins):
        ys, xs = np.nonzero(ins == iid)
        centers[int(iid)] = (float(xs.mean()), float(ys.mean()),
                             float(np.ptp(xs) + 1), float(np.ptp(ys) + 1),
                             float(td[ys, xs].max()))
        centers[int(iid) + 1] = centers[int(iid)]
    return projections, centers


def phase_build():
    from gaussiancity_tpu_torch import _kernels

    out = subprocess.run([_kernels.nvcc_path(), "--version"],
                         capture_output=True, text=True, check=True)
    log("nvcc: " + out.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    seconds = _kernels.build(force=True)
    log(f"built {sorted(seconds)} in {time.perf_counter() - t0:.2f} s "
        f"(per kernel: { {k: round(v, 2) for k, v in seconds.items()} })")
    for name, text in _kernels.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    for name in _kernels.KERNELS:
        _kernels.load(name)


def phase_card() -> str:
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("set torch.backends.cuda.matmul.allow_tf32 = False and "
        "torch.backends.cudnn.allow_tf32 = False")
    return card


def frame_scene(cfg, n: int, seed: int, device):
    """Seeded Gaussians filling the view of a camera at the origin that
    looks along +x, preprocessed and binned as ``rasterize`` does."""
    import torch

    from gaussiancity_tpu_torch.camera import CameraModel
    from gaussiancity_tpu_torch.ops.rasterizer import binning, preprocess

    ds, rc = cfg.dataset, cfg.rasterizer
    W, H = ds.sensor_size
    K = np.asarray(ds.cam_k).reshape(3, 3)
    cam = CameraModel(K, ds.sensor_size).params(
        np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]), device=device)
    rng = np.random.default_rng(seed)
    depth = rng.uniform(3.0, 120.0, n)
    y = rng.uniform(-1, 1, n) * depth * W / (2 * K[0, 0])
    z = rng.uniform(-1, 1, n) * depth * H / (2 * K[1, 1])
    arrays = [np.stack([depth, y, z], -1), rng.uniform(0.05, 0.95, n),
              rng.uniform(0.02, 0.3, (n, 3)),
              np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
              rng.uniform(0, 1, (n, 3))]
    means, op, sc, qu, co = (torch.as_tensor(a, dtype=torch.float32,
                                             device=device) for a in arrays)
    prep = preprocess.preprocess(means, op, sc, qu, co,
                                 torch.ones(n, dtype=torch.bool,
                                            device=device), cam)
    bins = binning.bin_gaussians(prep, H, W, rc.tile_h, rc.tile_w,
                                 rc.tile_capacity, gate16=True)
    return prep.attrs10(), bins, H, W


def phase_blend(cfg, device) -> dict:
    import torch

    from gaussiancity_tpu_torch.ops.rasterizer import binning, blend

    rc = cfg.rasterizer
    attrs, bins, H, W = frame_scene(cfg, N_BLEND_GAUSSIANS, seed=1,
                                     device=device)
    _, n_tx = binning.tile_grid(H, W, rc.tile_h, rc.tile_w)
    consts = blend.BlendConsts(
        tile_h=rc.tile_h, tile_w=rc.tile_w, n_tx=n_tx,
        alpha_min=rc.alpha_min, alpha_max=rc.alpha_max,
        t_eps=rc.transmittance_eps, ref_gate=True)
    idx, counts = bins.gauss_index, bins.counts
    bg = torch.tensor([0.1, 0.2, 0.3], device=device)
    log(f"K1 frame-scene inputs: truncated={int(bins.n_truncated)}")
    check(tuple(idx.shape) == (510, 2048), "K1 must run at the frame shape")
    entry = k1_measure("frame scene",
                       (attrs, idx, counts, (0.0, 0.0), bg, H, W, consts))
    entry.pop("touched_share")
    return {"name": "blend_fwd", "route": "cuda",
            "source": "gaussiancity_tpu_torch/csrc/blend_fwd.cu",
            "replaces": "gaussiancity_tpu/ops/rasterizer/blend_pallas.py:239",
            **entry}


def k1_measure(use: str, args) -> dict:
    """K1 against its plain version on ``args`` (those of one
    ``blend.blend_forward`` call): agreement, time, plain time and bound;
    also the share of pixels that at least one slot reaches."""
    import torch

    from gaussiancity_tpu_torch.ops.rasterizer import blend

    attrs, idx, counts, origin, _, H, W, consts = args
    T, K = idx.shape
    log(f"K1 {use} inputs: T={T} K={K} N={attrs.shape[0]} "
        f"slots={int(counts.sum())} max count={int(counts.max())}")
    got = blend.blend_forward(*args)
    want = blend.blend_forward_plain(*args)
    torch.cuda.synchronize()
    err_img = float((got[0] - want[0]).abs().max())
    err_T = float((got[1] - want[1]).abs().max())
    share = float((got[2] == want[2]).float().mean())
    touched = float((want[2] > 0).float().mean())
    log(f"K1 {use} vs plain: image max|d|={err_img:.3e} final_T max|d|="
        f"{err_T:.3e} n_contrib equal {share:.6f}; pixels reached "
        f"{touched:.4f}")
    check(err_img <= K1_TOL and err_T <= K1_TOL,
          f"K1 ({use}) image/final_T differ from the plain version by more "
          f"than {K1_TOL}")
    check(share >= MATCH_SHARE,
          f"K1 ({use}) n_contrib differs from the plain version")
    check(float(want[0].std()) > 0.01, f"K1 ({use}) renders nothing")
    log(f"K1 {use} bit-equal to the plain version (image, final_T, "
        f"n_contrib): {[torch.equal(a, b) for a, b in zip(got, want[:3])]}")
    ms = cuda_time_ms(lambda: blend.blend_forward(*args))
    plain_ms = cuda_time_ms(lambda: blend.blend_forward_plain(*args),
                            iters=2, warmup=1)
    # bound: bytes each input read once / each output written once, and
    # the operations this scene needs: the (pixel, slot) pairs tested
    # before the pixel saturates where the 16x16 gate holds, the blend of
    # the eligible ones among them, and one cull test per (sub-tile, slot)
    n_slots = int(counts.sum())
    kmask = torch.arange(K, device=idx.device)[None, :] < counts[:, None]
    n_gauss = int(torch.unique(idx[kmask]).numel())
    n_bytes = (n_gauss * attrs.shape[1] * 4 + n_slots * 4 + T * 4
               + H * W * (3 + 1 + 1) * 4)
    n_eval = int(want[3].sum())
    work = blend.blend_work(attrs, idx, counts, want[3], origin, consts)
    # a warp (8 x 4 pixels) runs until its last pixel saturates: its
    # slots over its mean pixel's, on this scene
    per_px = blend._to_tiles(want[3], consts, T).float()
    per_warp = per_px.reshape(T, consts.tile_h // 4, 4, consts.tile_w // 8,
                              8)
    overshoot = float(per_warp.amax(dim=(2, 4)).sum()) * 32 / n_eval
    log(f"K1 {use} saturation: a warp of 8x4 pixels tests {overshoot:.4f} "
        "x its mean pixel's slots")
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (work.pairs * BLEND_FLOP_PER_GATED
             + work.eligible * BLEND_FLOP_PER_ELIGIBLE
             + work.sub_tile_tests * BLEND_CULL_OPS) / FP32_FLOP_PER_S * 1e3
    t_tested = n_eval * BLEND_FLOP_PER_EVAL / FP32_FLOP_PER_S * 1e3
    log(f"K1 {use}: {ms:.4f} ms, plain {plain_ms:.2f} ms; bound: {n_bytes} B"
        f" -> {t_bytes:.5f} ms, {work.pairs} gated pairs ({work.eligible} "
        f"eligible) and {work.sub_tile_tests} sub-tile tests -> "
        f"{t_ops:.5f} ms; every tested pair ({n_eval}) -> {t_tested:.5f} ms"
        f" (tested_bound_ms)")
    return {"max_abs_err": max(err_img, err_T), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "gated_pairs": work.pairs,
            "eligible_pairs": work.eligible,
            "sub_tile_tests": work.sub_tile_tests, "tested_pairs": n_eval,
            "tested_bound_ms": max(t_bytes, t_tested),
            "warp_overshoot": overshoot, "touched_share": touched}


def city_pipeline(cfg, device):
    from gaussiancity_tpu_torch.inference.pipeline import InferencePipeline
    from gaussiancity_tpu_torch.models.generator import Generator

    import torch

    gen = Generator(cfg.network, n_classes=cfg.dataset.n_classes,
                    proj_size=cfg.dataset.proj_size)
    gen.reset_parameters(torch.Generator().manual_seed(0))
    return InferencePipeline(cfg, {"REST": gen}, max_points=262144,
                             vol_shape=(512, 512, 192), device=device)


def phase_raycast(pipe, projections, poses) -> dict:
    import torch

    from gaussiancity_tpu_torch.ops import visibility as vis

    points = pipe.build_points(projections)
    pipe.build_volume(points)
    vol, occ = pipe._vol, pipe._occ
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rebuilt = vis.pack_occupancy(vol)
    torch.cuda.synchronize()
    pack_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(getattr(occ, k).view(torch.int32),
                          getattr(rebuilt, k).view(torch.int32))
              for k in ("occ_words", "coarse_cols", "coarse2_cols"))
          and occ.ztop == rebuilt.ztop,
          "the cached occupancy tables differ from a rebuild")
    del rebuilt
    log(f"V1 occupancy tables: occ_words {tuple(occ.occ_words.shape)}, "
        f"coarse {tuple(occ.coarse_cols.shape)}, coarse2 "
        f"{tuple(occ.coarse2_cols.shape)}; pack_occupancy {pack_ms:.2f} ms "
        "(host clock, device synchronised; once per volume)")
    W, H = pipe.ds.sensor_size
    K = np.asarray(pipe.ds.cam_k).reshape(3, 3)
    pose = poses[1]
    dev = vol.device
    f32 = dict(dtype=torch.float32, device=dev)
    rays = vis.world_ray_basis(
        torch.tensor([pose[k] for k in ("tx", "ty", "tz")], **f32),
        torch.tensor([pose[k] for k in ("qx", "qy", "qz", "qw")], **f32),
        pipe._offsets)
    entry = v1_measure("frame view", vol, occ, rays, float(K[0, 0]),
                       (float(K[1, 2]), float(K[0, 2])), (H, W))
    entry["pack_occupancy_ms"] = pack_ms
    return {"name": "raycast", "route": "cuda",
            "source": "gaussiancity_tpu_torch/csrc/raycast.cu",
            "replaces": "gaussiancity_tpu/ops/visibility.py:154 "
                        "(ray_voxel_intersection, an XLA while_loop; no "
                        "Pallas kernel)", **entry}


def v1_measure(what: str, vol, occ, rays, cam_f: float, cam_c, img_dims
               ) -> dict:
    """V1 against its plain version on one view (voxel ids and depths
    bit-equal), its time and the plain version's on the card, and its
    bound: the cells and the bytes the walk needs, and the steps and jumps
    V1's design takes on this view (``raycast_work``)."""
    import torch

    from gaussiancity_tpu_torch.ops import visibility as vis

    H, W = img_dims
    view = (vol, rays, cam_f, cam_c, (H, W))
    args, tables = view + (occ.ztop,), view + (occ,)
    log(f"V1 inputs ({what}): volume {tuple(vol.shape)} "
        f"({int((vol != 0).sum())} occupied) rays {H}x{W} "
        f"ztop={occ.ztop}")
    got = vis.raycast(*tables)
    want = vis.raycast_plain(*args)
    torch.cuda.synchronize()
    share = float((got[0] == want[0]).float().mean())
    both = (got[0] == want[0]) & (want[0] != 0)
    err = float((got[1][both] - want[1][both]).abs().max())
    hits = float((want[0] != 0).float().mean())
    log(f"V1 vs plain ({what}): voxel ids equal {share:.6f}, depth max|d| "
        f"on equal hits {err:.3e}, hit share {hits:.4f}")
    check(torch.equal(got[0], want[0]),
          f"V1 voxel ids differ from the plain version ({what})")
    check(torch.equal(got[1], want[1]),
          f"V1 depths are not bit-equal to the plain version ({what})")
    check(hits > 0.5, f"V1 test view sees too little of the city ({what})")
    ms = cuda_time_ms(lambda: vis.raycast(*tables))
    plain_ms = cuda_time_ms(lambda: vis.raycast_plain(*args), iters=2,
                            warmup=1)
    n_steps, n_cells = int(want[2].sum()), int(want[3])
    n_bytes = n_cells * 4 + 12 * 4 + H * W * 8
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_steps * RAYCAST_OPS_PER_STEP / FP32_FLOP_PER_S * 1e3
    log(f"V1 ({what}): {ms:.4f} ms, plain {plain_ms:.2f} ms; the walk's "
        f"bound: {n_bytes} B ({n_cells} cells read) -> {t_bytes:.5f} ms, "
        f"{n_steps} DDA steps -> {t_ops:.5f} ms")
    # the work the function needs: the cells this design still steps
    # through and the empty regions it jumps over, counted by the kernel's
    # counting variant on this view
    again = vis.raycast_work(*tables)
    torch.cuda.synchronize()
    check(torch.equal(again[0], want[0]) and torch.equal(again[1], want[1]),
          f"V1 with its work count differs from the plain version ({what})")
    work = again[2]
    n_design, n_jumps = int(work[..., 0].sum()), int(work[..., 1].sum())
    check(0 < n_design <= n_steps, "V1 stepped more cells than the walk")
    t_design = ((n_design * RAYCAST_OPS_PER_STEP
                 + n_jumps * RAYCAST_OPS_PER_JUMP) / FP32_FLOP_PER_S * 1e3)
    log(f"V1 design work ({what}): {n_design} steps ({n_design / n_steps:.4f}"
        f" of the walk's) and {n_jumps} jumps over empty regions -> "
        f"{t_design:.5f} ms; the kernels line's bound is "
        f"{max(t_bytes, t_design):.5f} ms (the walk's under walk_bound_ms)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_design),
            "bound_by": "bytes" if t_bytes >= t_design else "operations",
            "library_ms": None, "walk_steps": n_steps,
            "design_steps": n_design, "design_jumps": n_jumps,
            "walk_bound_ms": max(t_bytes, t_ops)}


def small_config():
    """The tiny REST config of the CPU tests (tests/test_inference.py)."""
    from gaussiancity_tpu_torch.config import (
        Config, DatasetConfig, GaussianNetworkConfig, PTv3Config,
        RasterizerConfig)

    return Config(
        dataset=DatasetConfig(sensor_size=(128, 64), proj_size=64,
                              cam_k=(60.0, 0, 64.0, 0, 60.0, 32.0, 0, 0, 1)),
        network=GaussianNetworkConfig(
            scale_factor=0.5, global_encoder_n_blocks=2,
            hash_grid_n_levels=2, hash_grid_level_dim=2,
            hash_grid_map_size=8, mlp_hidden_dim=16,
            ptv3=PTv3Config(enabled=False)),
        rasterizer=RasterizerConfig(tile_capacity=128))


def small_city():
    """The tiny city of the CPU tests: two box buildings on a 64x64 map."""
    ins = np.ones((64, 64), np.int16)
    ins[10:20, 10:20] = 100
    ins[30:42, 30:44] = 102
    td = np.where(ins >= 100, 18, 2).astype(np.int16)
    projections = {"REST": {
        "INS": ins, "SEG": np.where(ins >= 100, 2, ins).astype(np.int16),
        "TD_HF": td, "BU_HF": np.zeros((64, 64), np.int16),
        "PTS": np.ones((64, 64), bool)}}
    centers = {i: (32.0, 32.0, 64.0, 64.0, 20.0) for i in range(200)}
    return projections, centers


def phase_small_reference():
    """A small trajectory on the card (kernels) and on the CPU (plain
    versions) with the same seeded weights: the frames must agree."""
    import torch

    from gaussiancity_tpu_torch.inference.pipeline import (
        InferencePipeline, get_orbit_camera_poses)
    from gaussiancity_tpu_torch.models.generator import Generator

    cfg = small_config()
    projections, centers = small_city()
    poses = get_orbit_camera_poses(64, n_points=2, radius=30, altitude=30)
    frames = {}
    for dev in ("cuda", "cpu"):
        gen = Generator(cfg.network, n_classes=8, proj_size=64)
        gen.reset_parameters(torch.Generator().manual_seed(5))
        pipe = InferencePipeline(cfg, {"REST": gen}, max_points=4096,
                                 vol_shape=(72, 72, 24), device=dev)
        frames[dev] = pipe.render_trajectory(projections, centers, poses)
    for a, b in zip(frames["cuda"], frames["cpu"]):
        check(a.shape == (64, 128, 3) and a.dtype == np.uint8,
              "small frame has the wrong shape")
        d = np.abs(a.astype(int) - b.astype(int))
        log(f"small frame card vs CPU: equal {float((d == 0).mean()):.5f}, "
            f"within 1 {float((d <= 1).mean()):.5f}, max {int(d.max())}, "
            f"std {float(a.std()):.2f}")
        check((d <= 1).mean() >= 0.99 and a.std() > 1,
              "small frame on the card disagrees with the CPU reference")


def phase_frame(pipe, projections, centers, poses, style_lut=None,
                what: str = "frame path"):
    """Warm-up pass (the first frame rendered once more, keeping its
    hash-grid inputs, then every frame), then a timed pass with the
    kernels' launch counts set to 0 just before it.  Returns the launches
    (with the median frame time without set-up under "median_ms"), the
    first frame's G1 arguments and the timed pass's frames."""
    import torch

    from gaussiancity_tpu_torch.ops import hash_grid
    from gaussiancity_tpu_torch.ops import visibility as vis
    from gaussiancity_tpu_torch.ops.rasterizer import blend

    t0 = time.perf_counter()
    g1_args = capture_calls(
        [(hash_grid, "hash_encode_fwd")],
        lambda: pipe.render_trajectory(projections, centers, poses[:1],
                                       style_lut=style_lut))["hash_encode_fwd"]
    check(len(g1_args) == 1, f"the {what} must call the hash grid once")
    pipe.render_trajectory(projections, centers, poses, style_lut=style_lut)
    log(f"{what} warm-up: {time.perf_counter() - t0:.2f} s")
    pipe.stage_ms.clear()
    pipe.frame_stats.clear()
    pipe._pts_fp = None  # rebuild the volume: the timed pass is complete
    torch.cuda.reset_peak_memory_stats()
    blend.blend_forward.launches = 0
    vis.raycast.launches = 0
    hash_grid.hash_encode_fwd.launches = 0
    t0 = time.perf_counter()
    frames = pipe.render_trajectory(projections, centers, poses,
                                    style_lut=style_lut)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"blend_fwd": blend.blend_forward.launches,
                "raycast": vis.raycast.launches,
                "hash_encode_fwd": hash_grid.hash_encode_fwd.launches}
    n = len(poses)
    log(f"{what}: {n} frames of {frames[0].shape} in {wall:.3f} s -> "
        f"{wall / n * 1e3:.2f} ms/frame (set-up included); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for stage, ms in pipe.stage_ms.items():
        log(f"  stage {stage:14s} " + " ".join(f"{m:9.2f}" for m in ms)
            + f"   mean {sum(ms) / len(ms):9.2f}"
            f" median {float(np.median(ms)):9.2f} ms")
    # per-frame stages (one entry per frame; generator_<model> splits the
    # generator stage): extrude and volume are per-trajectory set-up
    per_frame = [ms for stage, ms in pipe.stage_ms.items()
                 if len(ms) == n and not stage.startswith("generator_")]
    frame_ms = [sum(col) for col in zip(*per_frame)]
    log("frame ms without set-up: " + " ".join(f"{m:.2f}" for m in frame_ms)
        + f"   mean {sum(frame_ms) / n:.2f} median "
        f"{float(np.median(frame_ms)):.2f} ms")
    for i, (f, st) in enumerate(zip(frames, pipe.frame_stats)):
        log(f"  frame {i}: std {float(f.std()):.2f} {st}")
        check(f.shape == (540, 960, 3) and f.dtype == np.uint8,
              "frame has the wrong shape")
        check(float(f.std()) > 1, f"frame {i} has no content")
    log(f"launches on the timed pass: {launches}")
    for name, count in launches.items():
        check(count >= n, f"kernel {name} was not launched on every frame")
    launches["median_ms"] = float(np.median(frame_ms))
    return launches, g1_args[0], frames


def trace_dir(what: str) -> str:
    """A fresh directory for one profiled pass's Chrome trace, under the
    run's output directory (removed at the end of the run)."""
    root = os.path.join(cli_root(), "traces")
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, f"{len(os.listdir(root)):02d}_"
                        + what.replace(" ", "_"))


def phase_profile(pipe, projections, centers, poses, style_lut=None):
    """One more pass under the port's ``utils.profiling.trace``
    (torch.profiler, a Chrome trace): device time by kernel and the
    device's busy share of the per-frame wall time (``--profile``)."""
    import torch

    from gaussiancity_tpu_torch.inference.pipeline import frame_to_uint8
    from gaussiancity_tpu_torch.utils import profiling

    # per-trajectory set-up outside the window: only the frames are traced
    state = pipe.prepare(projections, centers, style_lut)
    with torch.inference_mode():
        frame_to_uint8(pipe.render_pose(state[0], centers, *state[1:],
                                        poses[0])[0])
    torch.cuda.synchronize()
    with torch.inference_mode(), profiling.trace(
            trace_dir("frames")) as prof:
        t0 = time.perf_counter()
        for i, pose in enumerate(poses):
            with profiling.step_annotation("frame", i):
                frame_to_uint8(pipe.render_pose(
                    state[0], centers, *state[1:], pose)[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, wall_ms, f"{len(poses)} frames",
                   {f"frame#{i}" for i in range(len(poses))})


def synthetic_rest_batch(cfg, n_pts: int, seed: int, device):
    """The JAX package's benchmark batch (bench.py synthetic_rest_batch),
    drawn with numpy: points 5-250 m ahead of a camera at the origin that
    looks along +x, random RGB and seg targets, empty projections."""
    import torch

    ds = cfg.dataset
    Wc, Hc = ds.train_crop_size
    P = ds.proj_size
    rng = np.random.default_rng(seed)
    depth = rng.uniform(5.0, 250.0, (1, n_pts))
    pts = np.concatenate([
        np.stack([depth, rng.uniform(-0.8, 0.8, (1, n_pts)) * depth,
                  rng.uniform(-0.4, 0.4, (1, n_pts)) * depth], -1),
        rng.uniform(0.3, 1.0, (1, n_pts, 1)),
        rng.integers(0, 8, (1, n_pts, 1)).astype(np.float64),
        rng.uniform(-1, 1, (1, n_pts, 3)),
        np.zeros((1, n_pts, 1))], -1)
    arrays = {
        "pts": pts, "rgb": rng.uniform(-1, 1, (1, Hc, Wc, 3)),
        "seg": np.eye(ds.n_classes)[rng.integers(0, ds.n_classes,
                                                 (1, Hc, Wc))],
        "msk": np.ones((1, Hc, Wc, 1)), "proj_hf": np.zeros((1, P, P, 1)),
        "proj_seg": np.zeros((1, P, P, ds.n_classes)),
        "cam_pos": np.zeros((1, 3)), "cam_quat": np.array([[0.0, 0, 0, 1]])}
    batch = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
             for k, v in arrays.items()}
    batch["pts_mask"] = torch.ones((1, n_pts), dtype=torch.bool,
                                   device=device)
    batch["crp_xy"] = torch.tensor([[100, 40]], dtype=torch.int32,
                                   device=device)
    return batch


def rest_train_config():
    """The REST recipe at its full widths; the perceptual loss may run on
    random VGG weights (no converted ImageNet weights in the repository)."""
    from gaussiancity_tpu_torch.config import rest_recipe

    cfg = rest_recipe()
    return cfg.replace(train=cfg.train.replace(allow_random_vgg=True))


@contextlib.contextmanager
def wrapped_calls(targets, hook):
    """Within the block, each (module, name) of ``targets`` is replaced by
    a wrapper that returns ``hook(name, fn, args, kwargs)``, ``fn`` the
    original.  A wrapper counts the launches made under its name: the
    real counts see none of these."""
    originals = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(name, fn):
        def call(*args, **kwargs):
            return hook(name, fn, args, kwargs)
        call.launches = 0
        return call

    for mod, name, fn in originals:
        setattr(mod, name, wrap(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def capture_calls(targets, fn) -> dict:
    """Run ``fn`` with each (module, name) of ``targets`` wrapped to keep
    the (detached) positional arguments of every call, by name."""
    import torch

    captured = {name: [] for _, name in targets}

    def keep(name, fn_orig, args, kwargs):
        captured[name].append(tuple(
            a.detach() if isinstance(a, torch.Tensor) else a for a in args))
        return fn_orig(*args, **kwargs)

    with wrapped_calls(targets, keep):
        fn()
    return captured


def capture_step_inputs(trainer, batch, step=None):
    """One REST train step (``trainer.train_step``, or ``step``), keeping
    the arguments of its K1 and K2 calls, of its two K3 calls (the
    hash-grid and the per-Gaussian use), of its G1 call and of its G1b
    call."""
    from gaussiancity_tpu_torch.ops import hash_grid, hash_grid_bwd
    from gaussiancity_tpu_torch.ops.rasterizer import blend

    captured = capture_calls(
        [(blend, "blend_forward"), (blend, "blend_backward"),
         (hash_grid_bwd, "segment_sum_sorted"),
         (hash_grid, "hash_encode_fwd"), (hash_grid, "hash_encode_bwd")],
        lambda: (step or trainer.train_step)(batch))
    check(all(len(captured[k]) == 1 for k in (
        "blend_forward", "blend_backward", "hash_encode_fwd",
        "hash_encode_bwd")) and len(captured["segment_sum_sorted"]) == 2,
          "a REST train step must call K1, K2, G1 and G1b once each and K3 "
          "twice")
    captured["blend_fwd"] = captured.pop("blend_forward")[0]
    captured["blend_bwd"] = captured.pop("blend_backward")[0]
    captured["segment_sum"] = captured.pop("segment_sum_sorted")
    return captured


def k3_uses(calls, what: str) -> dict:
    """K3 against its plain version on each captured call of a REST step,
    by use ("hash_grid", "per_gaussian")."""
    uses = {}
    for keys, rows, n_rows in calls:
        kind = "hash_grid" if rows.shape[0] > 1 else "per_gaussian"
        uses[kind] = k3_measure(f"{what}, {kind}", keys, rows, n_rows)
    check(sorted(uses) == ["hash_grid", "per_gaussian"],
          "the train step must call K3 for both of its uses")
    return uses


def phase_grad_kernels(captured):
    """K2 and K3 against their plain versions on one REST train step's
    inputs (K3 on both of its uses)."""
    k2 = {"name": "blend_bwd", "route": "cuda",
          "source": "gaussiancity_tpu_torch/csrc/blend_bwd.cu",
          "replaces": "gaussiancity_tpu/ops/rasterizer/blend_pallas.py:350",
          **k2_measure("REST step", captured["blend_bwd"])}
    per_use = k3_uses(captured["segment_sum"], "REST step")
    k3 = {"name": "segment_sum", "route": "cuda",
          "source": "gaussiancity_tpu_torch/csrc/segment_sum.cu",
          "replaces": "gaussiancity_tpu/ops/hash_grid_bwd.py:57",
          **sum_uses(per_use), "uses": per_use}
    for u in per_use.values():
        del u["t_bytes"], u["t_ops"]
    log("K3 line: both uses of one REST step summed (ms, plain, library, "
        "bound), and each use under \"uses\"")
    return [k2, k3]


def sum_uses(per_use: dict) -> dict:
    """One kernel's uses summed: ms, plain and library ms and the two
    bounds (the larger is ``bound_ms``); the worst error."""
    tot = {k: sum(u[k] for u in per_use.values())
           for k in ("ms", "plain_ms", "library_ms", "t_bytes", "t_ops")}
    return {"max_abs_err": max(u["max_abs_err"] for u in per_use.values()),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": max(tot["t_bytes"], tot["t_ops"]),
            "bound_by": ("bytes" if tot["t_bytes"] >= tot["t_ops"]
                         else "operations"),
            "library_ms": tot["library_ms"]}


def k2_measure(use: str, args, shape=(280, 1024, 448, 640)) -> dict:
    """K2 against its plain version on one train step's captured inputs:
    agreement on the live rows, a repeat, time, plain time and bound."""
    import torch

    from gaussiancity_tpu_torch.ops.rasterizer import blend

    attrs, idx, k_hi, origin, _, _, final_T, _, consts = args
    T, K = idx.shape
    H, W = final_T.shape
    log(f"K2 {use} inputs: T={T} K={K} N={attrs.shape[0]} image {H}x{W} "
        f"origin {origin} slots to replay {int(k_hi.sum())} max k_hi "
        f"{int(k_hi.max())}")
    check((T, K, H, W) == tuple(shape),
          f"K2 must run at its use's shape {shape}")
    # the live rows: the first sum(k_hi), compact
    n_rows = int(k_hi.sum())
    got = blend.blend_backward(*args)[:n_rows]
    again = blend.blend_backward(*args)[:n_rows]
    want = blend.blend_backward_plain(*args)[:n_rows]
    torch.cuda.synchronize()
    scale = want.abs().amax(dim=0)
    err = (got - want).abs()
    rel = float((err / scale.clamp(min=1e-30)).max())
    log(f"K2 {use} vs plain: max|d| {float(err.max()):.3e}, largest |d| / "
        f"column scale {rel:.3e} (column scales "
        f"{[f'{v:.3e}' for v in scale]}); repeat bit-equal "
        f"{torch.equal(got, again)}")
    check(bool((err <= K2_RTOL * scale).all()),
          f"K2 ({use}) differs from the plain version by more than "
          f"{K2_RTOL} of a column's scale")
    check(torch.equal(got, again), f"K2 ({use}) differs between runs")
    check(float(scale.min()) > 0, f"K2 ({use}) inputs give a zero column")
    ms = cuda_time_ms(lambda: blend.blend_backward(*args))
    plain_ms = cuda_time_ms(lambda: blend.blend_backward_plain(*args),
                            iters=2, warmup=1)
    # bound: slot indices and the rows of the Gaussians they name read
    # once, four pixel planes read once, the live rows written once; the
    # operations this step needs: the (pixel, slot < n_contrib) pairs
    # where the 16x16 gate holds, ~63 more for each counted one, and one
    # cull test per (sub-tile, slot)
    n_contrib = args[7]
    live = torch.arange(K, device=idx.device)[None, :] < k_hi[:, None]
    n_gauss = int(torch.unique(idx[live]).numel())
    n_bytes = (n_rows * 4 + n_gauss * 10 * 4 + T * 4 + H * W * 6 * 4
               + n_rows * 9 * 4)
    work = blend.blend_work(attrs, idx, k_hi, n_contrib, origin, consts)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (work.pairs * BLEND_BWD_FLOP_PER_GATED
             + work.eligible * BLEND_BWD_FLOP_PER_COUNTED
             + work.sub_tile_tests * BLEND_CULL_OPS) / FP32_FLOP_PER_S * 1e3
    # the bound over every (in-image pixel, slot < k_hi) pair tested, with
    # all [T * K, 9] rows written
    tid = torch.arange(T, device=idx.device)
    n_tx = consts.n_tx
    px_w = torch.clamp(W - (tid % n_tx) * consts.tile_w, max=consts.tile_w)
    px_h = torch.clamp(H - (tid // n_tx) * consts.tile_h, max=consts.tile_h)
    n_eval = int((px_w * px_h * k_hi).sum())
    t_tested = max((n_bytes - n_rows * 9 * 4 + T * K * 9 * 4)
                   / HBM_BYTES_PER_S,
                   n_eval * BLEND_BWD_FLOP_PER_EVAL / FP32_FLOP_PER_S) * 1e3
    log(f"K2 {use}: {ms:.4f} ms, plain {plain_ms:.2f} ms; bound: {n_bytes} "
        f"B -> {t_bytes:.5f} ms, {work.pairs} gated pairs ({work.eligible} "
        f"counted) and {work.sub_tile_tests} sub-tile tests -> {t_ops:.5f} "
        f"ms; every tested pair ({n_eval}) -> {t_tested:.5f} ms "
        "(tested_bound_ms)")
    return {"max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "gated_pairs": work.pairs,
            "counted_pairs": work.eligible,
            "sub_tile_tests": work.sub_tile_tests, "tested_pairs": n_eval,
            "tested_bound_ms": t_tested, "slots": n_rows}


def k3_measure(use: str, keys, rows, n_rows) -> dict:
    """K3 against its plain version on one captured call, twice
    (bit-equal), timed against ``index_add_`` in turns; fails if slower."""
    import torch

    from gaussiancity_tpu_torch.ops import hash_grid_bwd

    L, M, C = rows.shape
    got = hash_grid_bwd.segment_sum_sorted(keys, rows, n_rows)
    again = hash_grid_bwd.segment_sum_sorted(keys, rows, n_rows)
    want = hash_grid_bwd.segment_sum_sorted_plain(keys, rows, n_rows)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    # the runs of equal kept keys, which set the kernel's work
    kept = keys[(keys >= 0) & (keys < n_rows)]
    run_len = torch.unique_consecutive(kept, return_counts=True)[1]
    log(f"K3 {use}: L={L} M={M} C={C} R={n_rows}; vs plain max|d| "
        f"{err:.3e} (scale {scale:.3e}); repeat bit-equal "
        f"{torch.equal(got, again)}; {run_len.numel()} runs of kept "
        f"keys, median {int(run_len.median())}, longest "
        f"{int(run_len.max())} rows")
    check(torch.equal(got, again), f"K3 ({use}) differs between runs")
    check(err <= K3_RTOL * scale and scale > 0,
          f"K3 ({use}) differs from index_add_ by more than {K3_RTOL}")
    plain_ms = cuda_time_ms(
        lambda: hash_grid_bwd.segment_sum_sorted_plain(keys, rows, n_rows),
        iters=5, warmup=1)
    # the library call: one index_add_ over all levels (keys offset by
    # level, keys outside the table dropped beforehand)
    k = keys.long()
    keep = (k >= 0) & (k < n_rows)
    flat = (k + torch.arange(L, device=k.device)[:, None] * n_rows)[keep]
    flat_rows = rows[keep]

    def kernel():
        hash_grid_bwd.segment_sum_sorted(keys, rows, n_rows)

    def library():
        torch.zeros((L * n_rows, C), device=rows.device).index_add_(
            0, flat, flat_rows)

    # in turns (kernel, library, library, kernel), the better of each
    # pair: the two are compared, so they share the card's state
    runs = {"kernel": [], "library": []}
    for name in ("kernel", "library", "library", "kernel"):
        runs[name].append(cuda_time_ms(
            kernel if name == "kernel" else library, iters=50))
    ms, library_ms = min(runs["kernel"]), min(runs["library"])
    n_keys = int(keep.sum())
    n_bytes = n_keys * (4 + C * 4) + L * n_rows * C * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_keys * C / FP32_FLOP_PER_S * 1e3
    log(f"K3 {use}: {ms:.5f} ms (runs {runs['kernel']}), plain "
        f"{plain_ms:.3f} ms, index_add_ {library_ms:.5f} ms (runs "
        f"{runs['library']}); bound: {n_bytes} B -> {t_bytes:.5f} ms, "
        f"{n_keys * C} adds -> {t_ops:.6f} ms")
    check(ms <= library_ms,
          f"K3 ({use}) is slower than index_add_: {ms:.5f} ms against "
          f"{library_ms:.5f} ms")
    return {"L": L, "M": M, "C": C, "R": n_rows, "kept_keys": n_keys,
            "runs": run_len.numel(), "longest_run": int(run_len.max()),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "t_bytes": t_bytes, "t_ops": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err}


def phase_small_two_model(devices=("cuda", "cpu")):
    """A small REST + BLDG (PTv3) trajectory on the compact path, on the
    card (kernels) and on the CPU (plain versions), from the same seeded
    weights: the frames must agree."""
    import torch

    from gaussiancity_tpu_torch.config import (GaussianNetworkConfig,
                                               PTv3Config)
    from gaussiancity_tpu_torch.inference.pipeline import (
        InferencePipeline, get_orbit_camera_poses, get_style_lut)
    from gaussiancity_tpu_torch.models.generator import Generator

    cfg = small_config()
    # the small PTv3 of the JAX suite (tests/test_ptv3.py:94-104)
    bldg_net = GaussianNetworkConfig(
        scale_factor=0.65, encoder=None, encoder_out_dim=3,
        pos_emd="SIN_COS", sin_cos_freq_bends=2, z_dim=16, mlp_hidden_dim=32,
        ptv3=PTv3Config(
            order=("cord",), stride=(2, 2), enc_depths=(1, 1, 1),
            enc_channels=(8, 16, 32), enc_n_head=(1, 2, 4),
            enc_patch_size=(32, 32, 32), dec_depths=(1, 1),
            dec_channels=(8, 16), dec_n_head=(1, 2),
            dec_patch_size=(32, 32), mlp_ratio=2.0))
    projections, centers = small_city()
    lut = get_style_lut(centers, 16, seed=0)
    poses = get_orbit_camera_poses(64, n_points=6, radius=30,
                                   altitude=30)[1:3]
    frames, stats = [], []
    for dev in devices:
        models = {}
        for name, net, seed in (("REST", cfg.network, 5),
                                ("BLDG", bldg_net, 6)):
            models[name] = Generator(net, n_classes=8, proj_size=64)
            models[name].reset_parameters(torch.Generator().manual_seed(seed))
        pipe = InferencePipeline(cfg, models, max_points=4096,
                                 vol_shape=(72, 72, 24),
                                 class_budgets={"REST": 2048, "BLDG": 2048},
                                 device=dev)
        frames.append(pipe.render_trajectory(projections, centers, poses,
                                             style_lut=lut))
        stats.append([(st["n_REST"], st["n_BLDG"])
                      for st in pipe.frame_stats])
    for a, b, (n_rest, n_bldg) in zip(*frames, stats[0]):
        d = np.abs(a.astype(int) - b.astype(int))
        log(f"small two-model frame card vs CPU: equal "
            f"{float((d == 0).mean()):.5f}, within 1 "
            f"{float((d <= 1).mean()):.5f}, max {int(d.max())}, std "
            f"{float(a.std()):.2f}, buckets REST {n_rest} BLDG {n_bldg}")
        check(n_bldg > 0, "the small two-model frame has no BLDG point")
        check((d <= 1).mean() >= 0.99 and a.std() > 1,
              "small two-model frame on the card disagrees with the CPU")
    check(stats[0] == stats[1],
          "the card and the CPU fed the generators different points")


def two_model_pipeline(cfg, device, compute_dtype: str = "float32"):
    """The JAX package's two-model frame (bench.py:373-417): the REST and
    BLDG recipes at full widths, seeded, on the compact path; both
    generators computing in ``compute_dtype`` (the same weights in either
    dtype)."""
    import torch

    from gaussiancity_tpu_torch.config import bldg_recipe
    from gaussiancity_tpu_torch.inference.pipeline import InferencePipeline
    from gaussiancity_tpu_torch.models.generator import Generator

    models = {}
    for name, net, seed in (("REST", cfg.network, 0),
                            ("BLDG", bldg_recipe().network, 1)):
        net = net.replace(compute_dtype=compute_dtype)
        models[name] = Generator(net, n_classes=cfg.dataset.n_classes,
                                 proj_size=cfg.dataset.proj_size)
        models[name].reset_parameters(torch.Generator().manual_seed(seed))
    return InferencePipeline(cfg, models, max_points=sum(FRAME_BUDGETS.values()),
                             vol_shape=(512, 512, 192),
                             class_budgets=FRAME_BUDGETS, device=device)


def phase_two_model_frame(pipe, projections, centers, poses, lut,
                          what: str = "two-model frame"):
    """The two-model frame: warm-up pass (keeping the first frame's
    hash-grid inputs), timed pass, BLDG buckets non-empty."""
    launches, g1_args, frames = phase_frame(pipe, projections, centers,
                                            poses, lut, what=what)
    sizes = [(st["n_REST"], st["n_BLDG"]) for st in pipe.frame_stats]
    log(f"two-model buckets (REST, BLDG) per frame: {sizes}")
    for i, (_, n_bldg) in enumerate(sizes):
        check(n_bldg > 0, f"two-model frame {i} has an empty BLDG bucket")
    med = {stage: float(np.median(ms)) for stage, ms in pipe.stage_ms.items()
           if len(ms) == len(poses)}
    log(f"{what} stage medians (ms): " + json.dumps(
        {k: round(v, 2) for k, v in med.items()}))
    return launches, g1_args, frames


def phase_g1(use: str, args) -> dict:
    """G1 against its plain version on one captured use, twice; returns
    its numbers for ``g1_entry``."""
    import torch

    from gaussiancity_tpu_torch.ops import hash_grid

    inputs, emb = args[0], args[1]
    N, D = inputs.shape
    L, R_max, C = emb.shape
    got = hash_grid.hash_encode_fwd(*args)
    again = hash_grid.hash_encode_fwd(*args)
    want = hash_grid.hash_encode_fwd_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"G1 {use}: N={N} D={D} L={L} R_max={R_max} C={C}; vs plain "
        f"max|d| {err:.3e} (max|out| {scale:.3e}); repeat bit-equal "
        f"{torch.equal(got, again)}")
    check(torch.equal(got, again), f"G1 ({use}) differs between runs")
    check(scale > 0 and err <= G1_RTOL * scale,
          f"G1 ({use}) differs from the plain version by more than "
          f"{G1_RTOL} of its largest output")
    ms = cuda_time_ms(lambda: hash_grid.hash_encode_fwd(*args))
    plain_ms = cuda_time_ms(lambda: hash_grid.hash_encode_fwd_plain(*args),
                            iters=5, warmup=1)
    # bytes: every distinct table row this run's corners name, read once
    # (whole 32-byte sectors), the inputs and the output once;
    # operations: ~10 per corner and input dimension, 2 per channel
    idx = hash_grid._level_geometry(inputs, D, *args[2:])[0]
    n_rows = sum(int(torch.unique(idx[lvl]).numel()) for lvl in range(L))
    row_bytes = -(-C * 4 // 32) * 32
    n_bytes = n_rows * row_bytes + N * D * 4 + N * L * C * 4
    n_ops = N * L * (1 << D) * (10 * D + 2 * C)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    log(f"G1 {use}: {n_rows} distinct rows of {N * L << D} corner lookups "
        f"({N * L * (1 << D) * row_bytes} B at one sector each)")
    log(f"G1 {use}: {ms:.4f} ms, plain {plain_ms:.3f} ms; bound: {n_bytes} B"
        f" -> {t_bytes:.5f} ms, {n_ops} ops -> {t_ops:.5f} ms")
    return dict(N=N, ms=ms, plain_ms=plain_ms, err=err, t_bytes=t_bytes,
                t_ops=t_ops, rows=n_rows)


def g1_use(r: dict) -> dict:
    """One ``phase_g1`` result as a use entry of G1's line."""
    return {"N": r["N"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(r["t_bytes"], r["t_ops"]),
            "bound_by": ("bytes" if r["t_bytes"] >= r["t_ops"]
                         else "operations"),
            "max_abs_err": r["err"], "distinct_rows": r["rows"]}


def g1_entry(results: dict) -> dict:
    """G1's line: its uses summed (ms, plain, bound), the worst error,
    and each use under "uses" (its launches are filled in by ``main``)."""
    tot = {k: sum(r[k] for r in results.values())
           for k in ("ms", "plain_ms", "t_bytes", "t_ops")}
    uses = {use: g1_use(r) for use, r in results.items()}
    log("G1 line: its three uses summed (ms, plain, bound), each use under "
        "\"uses\"")
    return {"name": "hash_encode_fwd", "route": "cuda",
            "source": "gaussiancity_tpu_torch/csrc/hash_encode_fwd.cu",
            "replaces": "gaussiancity_tpu/ops/hash_grid.py:229 "
                        "(_hash_encode_fwd, an XLA gather; no Pallas kernel)",
            "max_abs_err": max(r["err"] for r in results.values()),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": max(tot["t_bytes"], tot["t_ops"]),
            "bound_by": ("bytes" if tot["t_bytes"] >= tot["t_ops"]
                         else "operations"),
            "library_ms": None, "uses": uses}


def phase_g1b(args) -> dict:
    """G1b against its plain version on the train step's captured
    backward inputs, twice (bit-equal); its time, bound and plain time."""
    import torch

    from gaussiancity_tpu_torch.ops import hash_grid

    inputs, emb, g = args[0], args[1], args[2]
    N, D = inputs.shape
    L, R_max, C = emb.shape
    need_emb, need_x = args[8], args[9]
    log(f"G1b inputs: N={N} D={D} L={L} R_max={R_max} C={C}; embedding "
        f"gradient {need_emb}, input gradient {need_x}")
    check(need_emb and need_x and (N, D, L, C) == (TRAIN_POINTS, 5, 16, 8),
          "G1b must run at the train step's shape, both gradients wanted")
    got = hash_grid.hash_encode_bwd(*args)
    again = hash_grid.hash_encode_bwd(*args)
    want = hash_grid.hash_encode_bwd_plain(*args)
    torch.cuda.synchronize()
    names = ("keys", "weights", "g_l")
    equal = {n: torch.equal(a, b) for n, a, b in zip(names, got, want)}
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    err = float((got[3] - want[3]).abs().max())
    scale = float(want[3].abs().max())
    log(f"G1b vs plain: bit-equal {equal}; d_inputs max|d| {err:.3e} "
        f"(max|d_inputs| {scale:.3e}, {err / scale:.3e} of it); repeat "
        f"bit-equal {repeat}")
    check(all(equal.values()), "G1b keys, weights or g_l differ from the "
          "plain version")
    check(repeat, "G1b differs between runs")
    check(scale > 0 and err <= G1B_RTOL * scale,
          f"G1b d_inputs differ from the plain version by more than "
          f"{G1B_RTOL} of the largest")
    ms = cuda_time_ms(lambda: hash_grid.hash_encode_bwd(*args))
    plain_ms = cuda_time_ms(lambda: hash_grid.hash_encode_bwd_plain(*args),
                            iters=5, warmup=1)
    # bytes: the inputs, g, each distinct corner row once (whole sectors),
    # the keys, weights and g_l written, d_inputs written; operations per
    # (point, level, corner): the weight and row (~10 per input), the dot
    # with g (2 per channel), the chain (D + 1 per input)
    n_rows = sum(int(torch.unique(got[0][lvl]).numel()) for lvl in range(L))
    row_bytes = -(-C * 4 // 32) * 32
    n_bytes = (N * D * 4 + N * L * C * 4 + n_rows * row_bytes
               + L * (N << D) * 8 + L * N * C * 4 + N * D * 4)
    n_ops = N * L * (1 << D) * (10 * D + 2 * C + D * (D + 1))
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    log(f"G1b: {ms:.4f} ms (the kernel and its one sum over the levels), "
        f"plain {plain_ms:.3f} ms; bound: {n_bytes} B ({n_rows} distinct "
        f"rows) -> {t_bytes:.5f} ms, {n_ops} ops -> {t_ops:.5f} ms")
    return {"name": "hash_encode_bwd", "route": "cuda",
            "source": "gaussiancity_tpu_torch/csrc/hash_encode_bwd.cu",
            "replaces": "gaussiancity_tpu/ops/hash_grid.py:248 "
                        "(_hash_encode_bwd, XLA; its segment sum is K3)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "distinct_rows": n_rows}


def device_launches(fn) -> Tuple[int, dict]:
    """Device operations (kernels, copies, fills) that one call of ``fn``
    issues, counted by torch.profiler: the total and the count by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            counts[e.key] = counts.get(e.key, 0) + e.count
    return sum(counts.values()), counts


def phase_bwd_launches(args) -> dict:
    """The hash-grid backward's device launches for one train step's
    call: the plain path (the torch backward the port ran before G1b)
    and the kernel path, each with the embedding gradient's sort, payload
    and K3 (``hash_grad_embeddings``)."""
    from gaussiancity_tpu_torch.ops import hash_grid, hash_grid_bwd

    R_max = args[1].shape[1]

    def backward(fn):
        keys, w, g_l, _ = fn(*args)
        hash_grid_bwd.hash_grad_embeddings(keys, w, g_l, R_max)

    before, _ = device_launches(
        lambda: backward(hash_grid.hash_encode_bwd_plain))
    after, by_name = device_launches(
        lambda: backward(hash_grid.hash_encode_bwd))
    log(f"hash-grid backward device launches per step: plain path "
        f"{before}, G1b path {after}")
    for name, count in sorted(by_name.items(), key=lambda kv: -kv[1]):
        log(f"  {count:4d}x {name[:110]}")
    check(after < before, "G1b did not cut the backward's launches")
    return {"plain_path": before, "kernel_path": after}


def phase_k4(device) -> dict:
    """The row-gather probe (K4) at its shape: a timed drive with the
    count set to 0 just before it, then K4 against its plain version."""
    import torch

    from gaussiancity_tpu_torch.ops import gather_rowsum as gr

    table, idx = gr.probe_inputs(seed=0, device=device)
    gr.gather_rowsum.launches = 0
    ms = cuda_time_ms(lambda: gr.gather_rowsum(table, idx))
    launches = gr.gather_rowsum.launches
    got = gr.gather_rowsum(table, idx)
    again = gr.gather_rowsum(table, idx)
    want = gr.gather_rowsum_plain(table, idx)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"K4 probe: table {tuple(table.shape)} {table.dtype}, idx "
        f"{tuple(idx.shape)}; vs plain max|d| {err:.3e} (max|out| "
        f"{scale:.3e}), bit-equal {torch.equal(got, want)}; repeat "
        f"bit-equal {torch.equal(got, again)}; launches on the probe's "
        f"timed drive {launches}")
    check(torch.equal(got, again), "K4 differs between runs")
    check(scale > 0 and torch.equal(got, want),
          "K4 is not bit-equal to its plain version")
    check(launches > 0, "the probe did not launch K4")
    plain_ms = cuda_time_ms(lambda: gr.gather_rowsum_plain(table, idx))
    # bytes: the distinct rows the indices name (16 bytes each), the
    # indices and the sums once
    M = idx.numel()
    n_rows = int(torch.unique(idx.clamp(0, table.shape[0] - 1)).numel())
    n_bytes = n_rows * 16 + M * 4 + M * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = M * 15 / FP32_FLOP_PER_S * 1e3
    log(f"K4: {ms:.5f} ms, plain {plain_ms:.4f} ms; bound: {n_bytes} B -> "
        f"{t_bytes:.5f} ms, {M * 15} ops -> {t_ops:.6f} ms")
    # time against the index count (uniform indices, 1/8 to 8 times the
    # probe's): a least-squares line gives the cost per index and per call,
    # beside the launch-to-launch time of an empty kernel
    rng = np.random.default_rng(1)
    counts = [M * 2 ** k // 8 for k in range(7)]
    inputs = [torch.as_tensor(rng.integers(0, table.shape[0], m, np.int32),
                              device=idx.device) for m in counts]
    # two passes, up and down the counts; the better time of each count
    runs = {m: [] for m in counts}
    for m, ix in list(zip(counts, inputs)) + list(zip(counts, inputs))[::-1]:
        runs[m].append(cuda_time_ms(lambda: gr.gather_rowsum(table, ix)))
    times = [min(runs[m]) for m in counts]
    per_index, per_call = np.polyfit(counts, times, 1)
    empty_ms = cuda_time_ms(lambda: torch.cuda._sleep(0))
    log(f"K4 against the index count {counts}: {[round(t, 5) for t in times]}"
        f" ms -> {per_index * 1e9:.3f} ps per index + {per_call:.5f} ms per "
        f"call (an empty kernel back to back: {empty_ms:.5f} ms); the "
        f"probe's rows as 32-byte sectors: {M * 32} B, "
        f"{M * 32 / (per_index * M) / 1e9:.3f} TB/s from L2")
    return {"name": "gather_rowsum", "route": "cuda",
            "source": "gaussiancity_tpu_torch/csrc/gather_rowsum.cu",
            "replaces": "scripts/bench_gather3.py:64",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "launches": launches,
            "ps_per_index": per_index * 1e9, "ms_per_call": per_call,
            "empty_kernel_ms": empty_ms}


def tiny_train_config():
    """The JAX suite's tiny train config (tests/test_train_step.py) with a
    one-step D warm-up."""
    from gaussiancity_tpu_torch.config import (
        Config, DatasetConfig, DiscriminatorOptim, GaussianNetworkConfig,
        PTv3Config, RasterizerConfig, TrainConfig)

    return Config(
        dataset=DatasetConfig(
            sensor_size=(256, 64), train_crop_size=(128, 32), n_classes=8,
            proj_size=32, cam_k=(100.0, 0, 128.0, 0, 100.0, 32.0, 0, 0, 1)),
        network=GaussianNetworkConfig(
            scale_factor=0.5, encoder="GLOBAL", encoder_out_dim=5,
            global_encoder_n_blocks=2, pos_emd="HASH_GRID",
            hash_grid_n_levels=4, hash_grid_level_dim=4,
            hash_grid_map_size=10, mlp_hidden_dim=32, dis_n_channel_base=8,
            ptv3=PTv3Config(enabled=False)),
        rasterizer=RasterizerConfig(tile_h=8, tile_w=128, tile_capacity=128),
        train=TrainConfig(
            allow_random_vgg=True,
            perceptual_loss_layers=("relu_1_1", "relu_2_1"),
            perceptual_loss_weights=(0.5, 1.0),
            discriminator=DiscriminatorOptim(n_warmup_iters=1)))


def phase_small_train(device, cfg=None, make_batch=None,
                      what: str = "tiny step"):
    """Two train steps of ``cfg`` (the tiny config) on the card (kernels)
    and on the CPU (plain versions) from the same seeded weights: losses
    and gradients agree."""
    cfg = cfg or tiny_train_config()
    make_batch = make_batch or (lambda dev: synthetic_rest_batch(
        cfg, 256, seed=4, device=dev))
    runs = step_runs(cfg, make_batch, (device, "cpu"), 3)
    worst = 0.0
    for i, ((m_card, g_card), (m_cpu, g_cpu)) in enumerate(
            zip(runs[device], runs["cpu"])):
        for k, v in m_cpu.items():
            ok = abs(m_card[k] - v) <= STEP_LOSS_RTOL * abs(v) + 1e-7
            check(np.isfinite(m_card[k]) and ok,
                  f"{what} {i} {k}: card {m_card[k]} vs CPU {v}")
        log(f"{what} {i} card vs CPU: GenLoss {m_card['GenLoss']:.6f} / "
            f"{m_cpu['GenLoss']:.6f}, DisLoss {m_card['DisLoss']:.6f} / "
            f"{m_cpu['DisLoss']:.6f}")
        for name, want in g_cpu.items():
            scale = float(want.abs().max())
            err = float((g_card[name] - want).abs().max())
            worst = max(worst, err / scale if scale > 0 else err)
            check(err <= STEP_GRAD_RTOL * scale,
                  f"{what} {i} gradient {name}: card vs CPU max|d| "
                  f"{err:.3e}, scale {scale:.3e}")
    log(f"{what} gradients card vs CPU: worst max|d| / scale {worst:.3e} "
        f"over {len(g_cpu)} parameters, both steps")
    return runs


def phase_train(trainer, batch, n_warm: int = 2, n_timed: int = 5):
    """The full-width REST train step: warm-up, then timed steps with the
    launch counts set to 0 just before them."""
    import torch

    from gaussiancity_tpu_torch.ops import hash_grid, hash_grid_bwd
    from gaussiancity_tpu_torch.ops.rasterizer import blend

    def snapshot():
        g = trainer.generator
        return {"hash table": g.pos_encoder.embeddings.detach().clone(),
                "MLP": g.ga_mlp.fc_1.weight.detach().clone(),
                "D": torch.cat([p.detach().reshape(-1) for p in
                                trainer.discriminator.parameters()])}

    t0 = time.perf_counter()
    for i in range(n_warm):
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        log(f"train warm-up step {i}: GenLoss {float(m['GenLoss']):.5f} "
            f"DisLoss {float(m['DisLoss']):.5f} RasterGradTruncated "
            f"{int(m['RasterGradTruncated'])}")
    log(f"train warm-up: {n_warm} steps in {time.perf_counter() - t0:.2f} s")
    trainer.stage_ms.clear()
    trainer.time_stages = True
    torch.cuda.reset_peak_memory_stats()
    # K3's launches by use: the wrapper's own count read around each of
    # its two callers
    k3 = hash_grid_bwd.segment_sum_sorted
    k3_callers = {"hash_grid": "hash_grad_embeddings",
                  "per_gaussian": "reduce_rows"}
    k3_calls = dict.fromkeys(k3_callers, 0)
    callers = {use: getattr(hash_grid_bwd, name)
               for use, name in k3_callers.items()}

    def observed(use):
        def call(*args):
            before = k3.launches
            out = callers[use](*args)
            k3_calls[use] += k3.launches - before
            return out
        return call

    for use, name in k3_callers.items():
        setattr(hash_grid_bwd, name, observed(use))
    counters = {"blend_fwd": blend.blend_forward,
                "blend_bwd": blend.blend_backward, "segment_sum": k3,
                "hash_encode_fwd": hash_grid.hash_encode_fwd,
                "hash_encode_bwd": hash_grid.hash_encode_bwd}
    for fn in counters.values():
        fn.launches = 0
    step_ms = []
    for i in range(n_timed):
        before = snapshot()
        counts = {name: fn.launches for name, fn in counters.items()}
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step = {name: fn.launches - counts[name]
                    for name, fn in counters.items()}
        check(min(per_step.values()) >= 1 and per_step["segment_sum"] >= 2,
              f"train step {i}: a kernel was not launched ({per_step})")
        after = snapshot()
        m = {k: float(v) for k, v in m.items()}
        log(f"train step {i}: {step_ms[-1]:.2f} ms " + " ".join(
            f"{k} {v:.5g}" for k, v in sorted(m.items())))
        for k, v in m.items():
            check(np.isfinite(v), f"train step {i}: {k} is not finite")
        check(m["RasterGradTruncated"] == 0,
              "RasterGradTruncated must be 0 at grad_budget 65536")
        for name in before:
            change = float((after[name] - before[name]).abs().max())
            check(change > 0, f"train step {i} left the {name} unchanged")
        log(f"  weights changed (max |d|): " + ", ".join(
            f"{n} {float((after[n] - before[n]).abs().max()):.3e}"
            for n in before))
    trainer.time_stages = False
    for use, name in k3_callers.items():
        setattr(hash_grid_bwd, name, callers[use])
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"launches on the {n_timed} timed steps: {launches} (each kernel on"
        f" every step, K3 twice); K3 calls by use {k3_calls}")
    check(sum(k3_calls.values()) == launches["segment_sum"]
          and min(k3_calls.values()) >= n_timed,
          "K3 must be launched for both of its uses on every train step")
    launches["segment_sum_by_use"] = k3_calls
    med = float(np.median(step_ms))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"train step: median {med:.2f} ms of {n_timed} (stage timers "
        f"synchronise the device at each boundary); peak device memory "
        f"{peak:.2f} GiB")
    for stage, ms in trainer.stage_ms.items():
        log(f"  stage {stage:10s} " + " ".join(f"{v:9.2f}" for v in ms)
            + f"   median {float(np.median(ms)):9.2f} ms")
    launches["median_ms"] = med
    launches["peak_gib"] = peak
    return launches


def phase_train_backward_ab(trainer, batch, n: int = 3) -> dict:
    """The step's backward stage with the hash-grid backward on G1b and,
    for comparison in the same run, on its plain version (the torch
    backward the port ran before G1b), in turns (plain, G1b, G1b, plain),
    ``n`` steps each: the medians of the backward stage and the step."""
    import torch

    from gaussiancity_tpu_torch.ops import hash_grid

    kernel = hash_grid.hash_encode_bwd
    runs = {"plain": [], "G1b": []}
    trainer.time_stages = True
    try:
        for which in ("plain", "G1b", "G1b", "plain"):
            if which == "plain":
                hash_grid.hash_encode_bwd = hash_grid.hash_encode_bwd_plain
            trainer.stage_ms.clear()
            steps = []
            for _ in range(n):
                t0 = time.perf_counter()
                trainer.train_step(batch)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t0) * 1e3)
            hash_grid.hash_encode_bwd = kernel
            runs[which].append((float(np.median(
                trainer.stage_ms["backward"])), float(np.median(steps))))
    finally:
        hash_grid.hash_encode_bwd = kernel
        trainer.time_stages = False
    out = {}
    for which, r in runs.items():
        out[which] = {"backward_ms": [b for b, _ in r],
                      "step_ms": [t for _, t in r]}
        log(f"train step with the {which} hash-grid backward: backward "
            f"stage medians {[round(b, 2) for b, _ in r]} ms, step medians "
            f"{[round(t, 2) for _, t in r]} ms ({n} steps each)")
    return out


def phase_train_profile(trainer, batch, n: int = 3):
    """``n`` train steps under the port's ``utils.profiling.trace``
    (``--profile``): device time by kernel and the device's busy share of
    the wall time."""
    import torch

    from gaussiancity_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    with profiling.trace(trace_dir("train_steps")) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            with profiling.step_annotation("train_step", i):
                trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(prof, wall_ms, f"{n} train steps",
                   {f"train_step#{i}" for i in range(n)})


def report_profile(prof, wall_ms: float, what: str,
                   annotations: set) -> None:
    """Device time by kernel and the busy share of ``wall_ms``.  The step
    annotations (``annotations``, the names ``step_annotation`` gave)
    also show on the device's timeline, spanning their kernels: they are
    not device work and are left out."""
    import torch

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and device_us(e) > 0 and e.key not in annotations]
    events.sort(key=lambda e: -device_us(e))
    busy_ms = sum(device_us(e) for e in events) / 1e3
    log(f"profile: {what}, wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.4f} of wall)")
    for e in events[:25]:
        log(f"  {device_us(e) / 1e3:10.3f} ms {e.count:6d}x {e.key[:100]}")
    # the port launches on one stream (cuDNN may overlap a little: the
    # LOCAL step read 0.83-0.95); an annotation counted as device work
    # spans its kernels and nearly doubles the share
    check(0 < busy_ms < 1.1 * wall_ms, "the profiler's device time is "
          "not within the wall time: an annotation counted as device work, "
          "or nothing traced")


# ---------------------------------------------------------------------------
# the BLDG (PTv3) train step and the training loop
# ---------------------------------------------------------------------------

BLDG_POINTS = 16384  # the BLDG recipe's train_max_points
# a gradient below this share of the model's largest is rounding noise of
# a quantity that is 0 in exact arithmetic (a bias that feeds a train-mode
# BatchNorm)
ZERO_GRAD = 1e-6


def tiny_bldg_config():
    """The tiny train config with a BLDG generator: no encoder, sin/cos,
    z 16, the small PTv3; the test crop is the train crop."""
    from gaussiancity_tpu_torch.config import PTv3Config
    from gaussiancity_tpu_torch.testing import TINY_PTV3

    cfg = tiny_train_config()
    return cfg.replace(
        dataset=cfg.dataset.replace(
            test_crop_size=cfg.dataset.train_crop_size),
        network=cfg.network.replace(
            scale_factor=0.65, encoder=None, encoder_out_dim=3,
            pos_emd="SIN_COS", sin_cos_freq_bends=4, z_dim=16,
            ptv3=PTv3Config(**TINY_PTV3)))


def ptv3_stats(generator) -> dict:
    """Copies of PTv3's BatchNorm running statistics, by name."""
    return {k: v.detach().cpu().clone()
            for k, v in generator.state_dict().items()
            if k.startswith("pt_net.") and k.endswith((".mean", ".var"))}


def phase_small_bldg_train(device):
    """Two tiny BLDG train steps (PTv3 in training mode, drop path 0) on
    the card (kernels) and on the CPU (plain versions) from the same seeded
    weights and the same z table: losses, gradients and PTv3's running
    statistics agree."""
    import torch

    from gaussiancity_tpu_torch.models import ptv3
    from gaussiancity_tpu_torch.testing import tiny_bldg_batch
    from gaussiancity_tpu_torch.training.step import Trainer
    from gaussiancity_tpu_torch.utils import helpers

    cfg = tiny_bldg_config()
    table = torch.randn((helpers.MAX_N_INSTANCES, 16),
                        generator=torch.Generator().manual_seed(7))
    get_z = helpers.get_z
    helpers.get_z = lambda gen, ins, z_dim: table.to(ins.device)[
        ins.long() % table.shape[0]]
    runs = {}
    try:
        for dev in (device, "cpu"):
            trainer = Trainer(cfg, device=dev, seed=3)
            ptv3.no_drop_path(trainer.generator)
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in tiny_bldg_batch(cfg, 256, seed=4).items()}
            steps = []
            for _ in range(2):
                m = {k: float(v) for k, v in trainer.train_step(batch).items()}
                grads = {f"{n}.{k}": p.grad.detach().cpu().clone()
                         for n, mod in (("G", trainer.generator),
                                        ("D", trainer.discriminator))
                         for k, p in mod.named_parameters()}
                steps.append((m, grads, ptv3_stats(trainer.generator)))
            runs[dev] = steps
    finally:
        helpers.get_z = get_z
    lr = cfg.train.generator.lr
    for i, ((m_card, g_card, s_card), (m_cpu, g_cpu, s_cpu)) in enumerate(
            zip(runs[device], runs["cpu"])):
        for k in m_cpu:
            ok = abs(m_card[k] - m_cpu[k]) <= (STEP_LOSS_RTOL * abs(m_cpu[k])
                                               + 1e-7)
            check(np.isfinite(m_card[k]) and ok,
                  f"tiny BLDG step {i} {k}: card {m_card[k]} vs CPU "
                  f"{m_cpu[k]}")
        check(m_card["PTv3PoolOverflow"] == 0,
              "tiny BLDG step: PTv3 neighbour overflow")
        gmax = max(float(g.abs().max()) for n, g in g_cpu.items()
                   if n.startswith("G."))
        worst, zero = 0.0, []
        for name, want in g_cpu.items():
            scale = float(want.abs().max())
            err = float((g_card[name] - want).abs().max())
            if name.startswith("G.") and scale < ZERO_GRAD * gmax:
                zero.append(name)
                check(float(g_card[name].abs().max()) < ZERO_GRAD * gmax,
                      f"tiny BLDG step {i} gradient {name} is not ~0 on the "
                      "card")
                continue
            worst = max(worst, err / scale if scale > 0 else err)
            check(err <= STEP_GRAD_RTOL * scale,
                  f"tiny BLDG step {i} gradient {name}: card vs CPU max|d| "
                  f"{err:.3e}, scale {scale:.3e}")
        for name, want in s_cpu.items():
            # a running mean follows its input's bias, which Adam moves by
            # up to lr either way where its gradient is rounding noise
            slack = (ptv3.MaskedBatchNorm.MOMENTUM * 2 * lr * i
                     if name.endswith(".mean") else 0)
            err = float((s_card[name] - want).abs().max())
            check(err <= STEP_GRAD_RTOL * float(want.abs().max()) + slack,
                  f"tiny BLDG step {i} running statistic {name}: card vs "
                  f"CPU max|d| {err:.3e}")
        log(f"tiny BLDG step {i} card vs CPU: GenLoss {m_card['GenLoss']:.6f}"
            f" / {m_cpu['GenLoss']:.6f}; worst gradient max|d| / scale "
            f"{worst:.3e} over {len(g_cpu) - len(zero)} tensors ({len(zero)} "
            f"0 in exact arithmetic, below {ZERO_GRAD} of the largest on "
            f"both); {len(s_cpu)} running statistics agree")


def bldg_train_config():
    """The BLDG recipe at its own widths (PTv3 32 -> 512 channels, patches
    of 1024, drop path 0.3, z 256, sin/cos); the perceptual loss may run
    on random VGG weights."""
    from gaussiancity_tpu_torch.config import bldg_recipe

    cfg = bldg_recipe()
    return cfg.replace(train=cfg.train.replace(allow_random_vgg=True))


def building_batch(cfg, projections, centers, device, seed: int = 0,
                   rank: int = 0):
    """16,384 points of one building's shell (facade and roof) from the
    synthetic city, as a train batch and as an eval batch.

    The city's projections are extruded as a building's are, bottom ring
    included; the building with the ``rank``-th most shell points is
    taken (rank 0: the most, at least 16,384), a sorted random subset of
    16,384 kept (as ``PadPoints`` keeps one), or all of them padded to
    16,384 with masked copies of the first, and normalised per instance
    as ``NormalizePointCords`` does.  The camera looks at the building's mid-height diagonally from
    0.75 of the distance at which its height fills the crop; the crops are
    centred and the targets random."""
    import torch

    from gaussiancity_tpu_torch.data.transforms import _normalize_rel_cords
    from gaussiancity_tpu_torch.inference.pipeline import (
        get_quat_from_look_at)
    from gaussiancity_tpu_torch.data.dataset_generator import (
        class_scale_table)
    from gaussiancity_tpu_torch.ops import extrusion as ext

    ds = cfg.dataset
    r = projections["REST"]
    pts = ext.extrude_points_np(r["INS"], r["TD_HF"], r["BU_HF"], r["PTS"],
                                ext.SegInsRelation(),
                                class_scale_table("GOOGLE_EARTH"))
    ids = pts[:, 4].astype(np.int64)
    bldg = np.where(ids >= 100, ids - (ids - 100) % 2, -1)
    uniq, counts = np.unique(bldg[bldg >= 0], return_counts=True)
    iid = int(uniq[np.argsort(-counts, kind="stable")[rank]])
    shell = pts[bldg == iid]
    log(f"BLDG batch: building {iid} of {len(uniq)} (rank {rank}), "
        f"{len(shell)} shell points (facade "
        f"{int((shell[:, 4] == iid).sum())}, roof "
        f"{int((shell[:, 4] == iid + 1).sum())})")
    check(rank > 0 or len(shell) >= BLDG_POINTS,
          f"no building of the city has {BLDG_POINTS} shell points")
    rng = np.random.default_rng(seed)
    n_valid = min(len(shell), BLDG_POINTS)
    shell = shell[np.sort(rng.choice(len(shell), n_valid, replace=False))]
    shell = np.concatenate([shell, np.repeat(shell[:1],
                                             BLDG_POINTS - n_valid, 0)])
    pts9 = np.concatenate([shell.astype(np.float32),
                           _normalize_rel_cords(shell, centers)], axis=1)
    cx, cy, _, _, d = centers[iid]
    W, H = ds.sensor_size
    focal = ds.cam_k[0]
    target = np.array([cx, cy, d / 2])
    dist = 0.75 * d * focal / ds.train_crop_size[1]
    cam_pos = target + np.array([dist / np.sqrt(2), dist / np.sqrt(2),
                                 d / 4])
    quat = get_quat_from_look_at(cam_pos, target)
    log(f"BLDG batch: camera {np.round(cam_pos, 1).tolist()} looking at "
        f"{np.round(target, 1).tolist()} from {dist:.1f} units")
    f32 = dict(dtype=torch.float32, device=device)

    def batch(crop):
        Wc, Hc = crop
        return {
            "pts": torch.as_tensor(pts9[None], **f32),
            "pts_mask": torch.arange(BLDG_POINTS, device=device)[None]
            < n_valid,
            "rgb": torch.as_tensor(rng.uniform(-1, 1, (1, Hc, Wc, 3)), **f32),
            "seg": torch.as_tensor(np.eye(ds.n_classes)[rng.integers(
                0, ds.n_classes, (1, Hc, Wc))], **f32),
            "msk": torch.ones((1, Hc, Wc, 1), **f32),
            "cam_pos": torch.as_tensor(cam_pos[None], **f32),
            "cam_quat": torch.as_tensor(np.asarray(quat)[None], **f32),
            "crp_xy": torch.tensor([[(W - Wc) // 2, (H - Hc) // 2]],
                                   dtype=torch.int32, device=device)}

    return batch(ds.train_crop_size), batch(ds.test_crop_size)


def stack_batches(batches):
    """Train batches of one sample each -> one batch of all of them."""
    import torch

    return {k: torch.cat([b[k] for b in batches]) for k in batches[0]}


def phase_bldg_kernels(trainer, batch, use: str = "BLDG step",
                       step=None) -> dict:
    """One BLDG step (``trainer.train_step``, or ``step``) with the
    arguments of its K1, K2 and K3 calls kept (one each per sample); K1,
    K2 and K3 (per Gaussian) against their plain versions on the first
    sample's.  Returns each kernel's use entry."""
    from gaussiancity_tpu_torch.ops import hash_grid_bwd
    from gaussiancity_tpu_torch.ops.rasterizer import blend

    captured = capture_calls(
        [(blend, "blend_forward"), (blend, "blend_backward"),
         (hash_grid_bwd, "segment_sum_sorted")],
        lambda: (step or trainer.train_step)(batch))
    B = batch["pts"].shape[0]
    check(all(len(v) == B for v in captured.values()),
          f"a BLDG step must call K1, K2 and K3 (per Gaussian) once a "
          f"sample: { {k: len(v) for k, v in captured.items()} }")
    k1 = k1_measure(use, captured["blend_forward"][0])
    log(f"{use}: the render reaches {k1['touched_share']:.4f} of the "
        "crop's pixels")
    k2 = k2_measure(use, captured["blend_backward"][0])
    k3 = k3_measure(f"{use}, per Gaussian",
                    *captured["segment_sum_sorted"][0])
    del k3["t_bytes"], k3["t_ops"]
    return {"blend_fwd": k1, "blend_bwd": k2, "segment_sum": k3}


def phase_bldg_train(trainer, batch, eval_batch, n_warm: int = 2,
                     n_timed: int = 5, what: str = "BLDG") -> dict:
    """The full-width BLDG train step: warm-up, then timed steps with the
    launch counts set to 0 just before them, the stage split (PTv3 timed
    by hooks on ``pt_net``), the peak memory; then one eval step that must
    leave PTv3's running statistics as they are.  Returns the launches
    with the median step, PTv3 stage and backward stage and the peak."""
    import torch

    from gaussiancity_tpu_torch.models import ptv3
    from gaussiancity_tpu_torch.ops import hash_grid_bwd
    from gaussiancity_tpu_torch.ops.rasterizer import blend

    gen = trainer.generator
    net = gen.pt_net.net
    drop = max(b.drop_path for b in net.modules()
               if isinstance(b, ptv3.PTBlock))
    log(f"BLDG trainer: PTv3 enc {net.cfg.enc_channels} dec "
        f"{net.cfg.dec_channels} patches {net.cfg.enc_patch_size[0]}, drop "
        f"path up to {drop}, z {trainer.cfg.network.z_dim}, "
        f"{sum(p.numel() for p in gen.parameters())} generator weights")

    def snapshot():
        return {"PTv3 stem": net.embedding_stem.kernel.detach().clone(),
                "PTv3 enc4": net.enc4_block1.mlp_fc2.weight.detach().clone(),
                "MLP": gen.ga_mlp.fc_1.weight.detach().clone(),
                "D": torch.cat([p.detach().reshape(-1) for p in
                                trainer.discriminator.parameters()])}

    t0 = time.perf_counter()
    for i in range(n_warm):
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        log(f"BLDG warm-up step {i}: GenLoss {float(m['GenLoss']):.5f} "
            f"DisLoss {float(m['DisLoss']):.5f} RasterGradTruncated "
            f"{int(m['RasterGradTruncated'])} PTv3PoolOverflow "
            f"{int(m['PTv3PoolOverflow'])}")
    log(f"BLDG warm-up: {n_warm} steps in {time.perf_counter() - t0:.2f} s")
    ptv3_ms = []

    def pre(module, args):
        torch.cuda.synchronize()
        module._t0 = time.perf_counter()

    def post(module, args, out):
        torch.cuda.synchronize()
        ptv3_ms.append((time.perf_counter() - module._t0) * 1e3)

    hooks = [gen.pt_net.register_forward_pre_hook(pre),
             gen.pt_net.register_forward_hook(post)]
    trainer.stage_ms.clear()
    trainer.time_stages = True
    torch.cuda.reset_peak_memory_stats()
    k3 = hash_grid_bwd.segment_sum_sorted
    reduce_rows = hash_grid_bwd.reduce_rows
    per_gaussian = [0]

    def observed(*args):
        before = k3.launches
        out = reduce_rows(*args)
        per_gaussian[0] += k3.launches - before
        return out

    hash_grid_bwd.reduce_rows = observed
    counters = {"blend_fwd": blend.blend_forward,
                "blend_bwd": blend.blend_backward, "segment_sum": k3}
    for fn in counters.values():
        fn.launches = 0
    step_ms = []
    try:
        for i in range(n_timed):
            before, stats = snapshot(), ptv3_stats(gen)
            counts = {name: fn.launches for name, fn in counters.items()}
            k3_before = per_gaussian[0]
            t0 = time.perf_counter()
            m = trainer.train_step(batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step = {name: fn.launches - counts[name]
                        for name, fn in counters.items()}
            B = batch["pts"].shape[0]
            check(min(per_step.values()) >= B
                  and per_gaussian[0] - k3_before >= B,
                  f"{what} step {i}: K1, K2 or K3 (per Gaussian) was not "
                  f"launched for every sample ({per_step})")
            after, stats_after = snapshot(), ptv3_stats(gen)
            m = {k: float(v) for k, v in m.items()}
            log(f"{what} step {i}: {step_ms[-1]:.2f} ms " + " ".join(
                f"{k} {v:.5g}" for k, v in sorted(m.items())))
            for k, v in m.items():
                check(np.isfinite(v), f"BLDG step {i}: {k} is not finite")
            check(m["RasterGradTruncated"] == 0,
                  "RasterGradTruncated must be 0 at grad_budget 65536")
            check(m["PTv3PoolOverflow"] == 0,
                  "PTv3PoolOverflow must be 0 on the building's points")
            for name in before:
                change = float((after[name] - before[name]).abs().max())
                check(change > 0, f"BLDG step {i} left the {name} unchanged")
            moved = sum(not torch.equal(stats[k], stats_after[k])
                        for k in stats)
            check(moved == len(stats),
                  f"BLDG step {i} moved {moved} of {len(stats)} running "
                  "statistics")
        log(f"  weights changed (max |d|, last step): " + ", ".join(
            f"{n} {float((after[n] - before[n]).abs().max()):.3e}"
            for n in before) + f"; all {len(stats)} running statistics moved")
    finally:
        trainer.time_stages = False
        hash_grid_bwd.reduce_rows = reduce_rows
        for h in hooks:
            h.remove()
    launches = {name: fn.launches for name, fn in counters.items()}
    launches["segment_sum_by_use"] = {"bldg_step": per_gaussian[0]}
    log(f"launches on the {n_timed} timed {what} steps: {launches}")
    check(per_gaussian[0] == launches["segment_sum"],
          "every K3 launch of a BLDG step must be the per-Gaussian one")
    med = float(np.median(step_ms))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{what} train step: median {med:.2f} ms of {n_timed} (stage "
        f"timers synchronise the device at each boundary); peak device "
        f"memory {peak:.2f} GiB")
    split = dict(trainer.stage_ms)
    split["ptv3"] = ptv3_ms
    split["sincos+mlp"] = [g - p for g, p in zip(split["generator"], ptv3_ms)]
    for stage, ms in split.items():
        log(f"  stage {stage:10s} " + " ".join(f"{v:9.2f}" for v in ms)
            + f"   median {float(np.median(ms)):9.2f} ms")
    launches.update(median_ms=med, peak_gib=peak,
                    ptv3_ms=float(np.median(ptv3_ms)),
                    backward_ms=float(np.median(split["backward"])))
    stats = ptv3_stats(gen)
    metrics, fake = trainer.eval_step(eval_batch)
    Wt, Ht = trainer.cfg.dataset.test_crop_size
    check(tuple(fake.shape) == (eval_batch["pts"].shape[0], Ht, Wt, 3)
          and np.isfinite(float(metrics["L1Loss"])),
          "the BLDG eval step must render the test crop")
    check(all(torch.equal(v, ptv3_stats(gen)[k]) for k, v in stats.items()),
          "the BLDG eval step changed PTv3's running statistics")
    log(f"BLDG eval step: L1Loss {float(metrics['L1Loss']):.5f}, fake "
        f"{tuple(fake.shape)}; PTv3's running statistics unchanged")
    return launches


def loop_config(out_dir: str):
    """A tiny BLDG config on the synthetic dataset for the training loop:
    two epochs, validation and a checkpoint after each."""
    from gaussiancity_tpu_torch.config import TestConfig

    cfg = tiny_bldg_config()
    return cfg.replace(
        exp_name="chip_smoke_loop", output_dir=out_dir,
        dataset=cfg.dataset.replace(
            name="SYNTHETIC", proj_size=64, map_size=0, pin_memory=(),
            train_min_pixels=4, train_n_instances=1,
            train_instance_range=(10, 16384), test_n_instances=1,
            test_instance_range=(10, 16384)),
        train=cfg.train.replace(n_epochs=2, max_points=256, log_freq=2,
                                ckpt_save_freq=1, n_workers=2,
                                prefetch_batches=2),
        test=TestConfig(test_freq=1))


def phase_train_loop(device, n_items: int = 4):
    """``train()`` on the card over ``SyntheticDataset`` (``n_items`` a
    split): one epoch with validation and a checkpoint, then a resume from
    that checkpoint for the second epoch; steps per second of each call
    (set-up, validation and checkpoint included)."""
    import functools

    from gaussiancity_tpu_torch.data import datasets
    from gaussiancity_tpu_torch.training import checkpoint
    from gaussiancity_tpu_torch.training.train import train

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "output", "chip_smoke_loop")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = loop_config(out_dir)
    ckpt_dir = os.path.join(out_dir, "ckpt", cfg.exp_name)
    synthetic = datasets.DATASETS["SYNTHETIC"]
    datasets.DATASETS["SYNTHETIC"] = functools.partial(
        datasets.SyntheticDataset, n_items=n_items)
    try:
        t0 = time.perf_counter()
        first = train(cfg.replace(train=cfg.train.replace(n_epochs=1)),
                      device=device)
        t1 = time.perf_counter()
        check(first.device.type == "cuda", "train() did not run on the card")
        check(checkpoint.latest_epoch(ckpt_dir) == 1,
              "train() wrote no epoch-1 checkpoint")
        resumed = train(cfg, resume_from=ckpt_dir, device=device)
        t2 = time.perf_counter()
        check(first.step == n_items and resumed.step == 2 * n_items,
              f"train() took {first.step} + {resumed.step - first.step} "
              f"steps, not {n_items} an epoch")
        check(checkpoint.latest_epoch(ckpt_dir) == 2,
              "the resumed train() wrote no epoch-2 checkpoint")
        log_path = os.path.join(out_dir, "logs", cfg.exp_name,
                                "scalars.jsonl")
        with open(log_path) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["Loss/Batch/GenLoss"] for r in rows
                  if "Loss/Batch/GenLoss" in r]
        val = [r["Loss/Epoch/L1Loss/Val"] for r in rows
               if "Loss/Epoch/L1Loss/Val" in r]
        overflow = [r["Raster/Batch/PTv3PoolOverflow"] for r in rows
                    if "Raster/Batch/PTv3PoolOverflow" in r]
        check(len(losses) == 2 * n_items and np.isfinite(losses).all(),
              f"train() logged {len(losses)} step losses")
        check(len(val) == 2 and np.isfinite(val).all(),
              "train() did not validate after each epoch")
        check(max(overflow) == 0, "train() saw a PTv3 neighbour overflow")
        log(f"training loop on the card: epoch 1 {first.step} steps in "
            f"{t1 - t0:.2f} s ({first.step / (t1 - t0):.3f} steps/s), "
            f"resumed epoch 2 {resumed.step - first.step} steps in "
            f"{t2 - t1:.2f} s ({(resumed.step - first.step) / (t2 - t1):.3f}"
            f" steps/s), set-up, validation and checkpoints included; "
            f"GenLoss {losses[0]:.4f} -> {losses[-1]:.4f}, val L1 {val}")
    finally:
        datasets.DATASETS["SYNTHETIC"] = synthetic
        shutil.rmtree(out_dir, ignore_errors=True)


# phases 16-18: the user's entry points.  Everything they write lives
# under output/chip_smoke_cli (removed at the end of the run).
DATASET_VIEWS = 8
DATASET_VOL = (640, 640, 256)  # the JAX package's default vol_shape
CLI_FRAMES = 8
CLI_TIMEOUT_S = 600
HANG_S = 1100  # the whole run's limit, the build included


def cli_root() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "output", "chip_smoke_cli")


@contextlib.contextmanager
def timed_calls(targets):
    """Within the block, each (module, name) of ``targets`` is wrapped to
    keep its wall time per call (the device synchronised before and
    after), by name."""
    import torch

    times = {name: [] for _, name in targets}

    def timed(name, fn, args, kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    with wrapped_calls(targets, timed):
        yield times


def cli_config(root: str, out_dir: str):
    """The tiny REST widths of phase 8 on the generated city: its 960x540
    views and projection window (2048 pixels), the loop phase's train
    settings, 32x32 tiles."""
    from gaussiancity_tpu_torch.config import (DatasetConfig,
                                               RasterizerConfig, TestConfig)
    from gaussiancity_tpu_torch.data.dataset_generator import CONSTANTS

    cfg = tiny_train_config()
    return cfg.replace(
        exp_name="chip_smoke_cli", output_dir=out_dir,
        dataset=DatasetConfig(
            dir=root, n_cities=1, n_views=DATASET_VIEWS,
            train_crop_size=(256, 128), test_crop_size=(256, 128),
            train_min_pixels=4,
            proj_size=CONSTANTS["GOOGLE_EARTH"]["PROJECTION_SIZE"],
            map_size=0),
        rasterizer=RasterizerConfig(),
        train=cfg.train.replace(n_epochs=1, max_points=256, log_freq=2,
                                ckpt_save_freq=1, n_workers=2,
                                prefetch_batches=2),
        test=TestConfig(test_freq=1))


E1_ROW_BYTES = 20  # a row (x, y, z, scale, instance) of int32


def view_targets():
    """The stages of a generated view, for ``timed_calls``."""
    from gaussiancity_tpu_torch.data import dataset_generator as dg
    from gaussiancity_tpu_torch.ops import visibility as vis

    return [(dg, "load_projections"), (dg, "get_centers_from_projections"),
            (dg, "generate_view"), (dg, "get_local_projections"),
            (dg, "get_points_from_projections"),
            (vis, "points_to_volume"), (vis, "visible_from_volume")]


def log_view_stages(t: dict, wall: float, n: int, what: str) -> dict:
    """Log the split of a generated view's time (``timed_calls`` of
    ``view_targets``) and return each stage's median in ms."""
    stages = {"extrude (E1, maps uploaded)": t["get_points_from_projections"],
              "local projections (host)": t["get_local_projections"],
              "volume": t["points_to_volume"],
              "raycast (occupancy tables, V1, instance map)":
                  t["visible_from_volume"]}
    stages["reindex, masks, copy back"] = [
        g - sum(col) for g, col in zip(t["generate_view"],
                                       zip(*stages.values()))]
    write = (wall - sum(t["generate_view"]) - t["load_projections"][0]
             - t["get_centers_from_projections"][0]) / n
    log(f"{what}: {n} views in {wall / 1e3:.2f} s ({wall / n:.1f} ms a "
        f"view); projections read {t['load_projections'][0]:.1f} ms, "
        f"centres {t['get_centers_from_projections'][0]:.1f} ms")
    for name, ms in stages.items():
        log(f"  stage {name}: " + " ".join(f"{m:.2f}" for m in ms)
            + f"   median {float(np.median(ms)):.2f} ms")
    log(f"  stage write (png + pkl, host): {write:.2f} ms a view (mean)")
    medians = {k: float(np.median(v)) for k, v in stages.items()}
    medians["write (host)"] = write
    return medians


def device_maps(maps: dict, device) -> tuple:
    """One category's INS, TD_HF, BU_HF and PTS mask on the card, as
    ``get_points_from_projections`` uploads them."""
    import torch

    return tuple(torch.as_tensor(np.ascontiguousarray(m), device=device)
                 for m in (maps["INS"], maps["TD_HF"], maps["BU_HF"],
                           maps["PTS"] != 0))


def e1_measure(use: str, maps: tuple, include_btm: bool) -> dict:
    """E1 against its plain version on one category's maps on the card
    (rows bit-equal, and on a repeat); the time of the whole call (count,
    scan, the host's read of the row count, emit) and of the padded form
    that skips the read, the plain version's time, and the bound: the
    maps read once as the caller passes them (int16 INS, TD_HF and BU_HF
    and a bool PTS from the PNG maps) and the rows written once over the
    memory rate."""
    import torch

    from gaussiancity_tpu_torch.data import dataset_generator as dg
    from gaussiancity_tpu_torch.ops import extrusion as ext

    args = (*maps, dg.get_seg_ins_relations("GOOGLE_EARTH"),
            dg.class_scale_table("GOOGLE_EARTH"), include_btm)
    got = ext.extrude_points_exact(*args)
    again = ext.extrude_points_exact(*args)
    want, n = ext.extrude_rows_plain(*args)
    torch.cuda.synchronize()
    rows = len(got)
    check(rows > 0 and int(n) == rows, f"E1 emitted no rows ({use})")
    err = float((got.long() - want.long()).abs().max()) \
        if got.shape == want.shape else float("inf")
    check(torch.equal(got, want),
          f"E1 is not bit-equal to its plain version ({use})")
    check(torch.equal(got, again), f"E1 differs between runs ({use})")
    ms = cuda_time_ms(lambda: ext.extrude_points_exact(*args))
    padded_ms = cuda_time_ms(lambda: ext.extrude_rows(*args,
                                                      capacity=rows))
    plain_ms = cuda_time_ms(lambda: ext.extrude_rows_plain(*args), iters=3,
                            warmup=1)
    H, W = maps[0].shape
    n_bytes = (sum(m.numel() * m.element_size() for m in maps)
               + rows * E1_ROW_BYTES)
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"E1 ({use}): maps {H}x{W} ("
        + ", ".join(str(m.dtype).removeprefix("torch.") for m in maps)
        + f"), {int(maps[3].sum())} masked pixels, "
        f"{rows} rows bit-equal to the plain version (and on a repeat); "
        f"{ms:.4f} ms a call (count, scan, the row count read, emit), "
        f"{padded_ms:.4f} ms padded (no read), plain {plain_ms:.2f} ms; "
        f"bound {n_bytes} B -> {bound:.5f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "padded_ms": padded_ms, "rows": rows, "pixels": H * W}


def phase_dataset_generation(projections, device="cuda",
                             vol_shape=DATASET_VOL) -> Tuple[str, dict, dict]:
    """``generate_city`` on the card over the synthetic city's maps (as
    PNGs) from 8 orbit poses at the JAX default volume: E1 once a category
    a view and V1 once a view, the split of a view's time, view 0
    bit-equal to the CPU's plain path, the files read back by
    ``GoogleEarthDataset``; E1 held and timed on view 0's maps, V1 on its
    volume.  Returns (the city directory, V1's and E1's ``dataset_view``
    uses)."""
    import torch
    from PIL import Image

    from gaussiancity_tpu_torch.data import dataset_generator as dg
    from gaussiancity_tpu_torch.data.datasets import get_dataset
    from gaussiancity_tpu_torch.inference.pipeline import (
        get_orbit_camera_poses)
    from gaussiancity_tpu_torch.ops import extrusion as ext
    from gaussiancity_tpu_torch.ops import visibility as vis

    root = os.path.join(cli_root(), "data")
    city = os.path.join(root, "City")
    dg.dump_projections(projections, os.path.join(city, "Projection"))
    # the frame phases' orbit (radius 220, altitude 260 over 512 pixels),
    # scaled to the map
    P = projections["REST"]["SEG"].shape[0]
    poses = get_orbit_camera_poses(P, n_points=DATASET_VIEWS,
                                   radius=220 * P // 512,
                                   altitude=260 * P // 512)
    dg.save_camera_poses(os.path.join(city, "CameraPoses.csv"), poses)
    targets = view_targets()
    vis.raycast.launches = 0
    ext.extrude_rows.launches = 0
    with timed_calls(targets) as t:
        t0 = time.perf_counter()
        dg.generate_city("GOOGLE_EARTH", city, vol_shape=vol_shape,
                         device=device)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = vis.raycast.launches
    e1_launches = ext.extrude_rows.launches
    n = DATASET_VIEWS
    check(launches == n, f"generate_city launched V1 {launches} times for "
          f"{n} views")
    check(e1_launches == n * len(projections),
          f"generate_city launched E1 {e1_launches} times for {n} views of "
          f"{len(projections)} categories")
    check(all(len(t[name]) == n for _, name in targets[2:]),
          "generate_city did not run every stage once a view")
    stages = log_view_stages(t, wall, n, "dataset generation (960x540 over "
                             f"a {vol_shape} volume)")
    log(f"  launches: V1 {launches}, E1 {e1_launches}")

    # view 0 again, on the CPU by the plain path: the same files
    projections_png = dg.load_projections(os.path.join(city, "Projection"))
    p0 = poses[0]
    t0 = time.perf_counter()
    data, ins_map = dg.generate_view(
        "GOOGLE_EARTH", projections_png,
        np.array([p0["tx"], p0["ty"], p0["tz"]]),
        np.array([p0["qx"], p0["qy"], p0["qz"], p0["qw"]]), vol_shape,
        device="cpu")
    cpu_s = time.perf_counter() - t0
    with open(os.path.join(city, "Points", "0000.pkl"), "rb") as f:
        card = pickle.load(f)
    with Image.open(os.path.join(city, "InstanceImage", "0000.png")) as img:
        card_ins = np.array(img)
    check(card.keys() == data.keys() == {"prj", "vpm", "msk", "pts"}
          and card["prj"].keys() == data["prj"].keys(),
          "the view's Points pkl has another schema")
    for key in ("vpm", "msk", "pts"):
        check(card[key].dtype == data[key].dtype
              and np.array_equal(card[key], data[key]),
              f"view 0's {key} on the card differs from the CPU's")
    for key, arr in data["prj"].items():
        check(np.array_equal(card["prj"][key], arr),
              f"view 0's prj {key} on the card differs from the CPU's")
    check(np.array_equal(card_ins, ins_map.astype(np.uint16)),
          "view 0's instance map on the card differs from the CPU's")
    log(f"dataset view 0 on the CPU (plain path) in {cpu_s:.1f} s: vpm, msk,"
        f" pts ({len(data['pts'])} visible points), prj and the instance map"
        " bit-equal to the card's files")

    # the footage a city needs for training, then one item of the val
    # split read from the files
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(city, "footage"))
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (540, 960, 3), np.uint8)).save(
            os.path.join(city, "footage", f"City_{i:02d}.jpeg"))
    cfg = cli_config(root, os.path.join(cli_root(), "out"))
    ds = get_dataset(cfg, "GOOGLE_EARTH", "val")
    item = ds[0]
    Wc, Hc = cfg.dataset.test_crop_size
    check(len(ds) == 1 and item["pts"].shape == (cfg.train.max_points, 9)
          and item["rgb"].shape == (Hc, Wc, 3)
          and item["proj_hf"].shape == (cfg.dataset.proj_size,) * 2 + (1,)
          and item["pts_mask"].sum() > 0,
          "GoogleEarthDataset cannot read the generated city")
    log(f"GoogleEarthDataset val item 0: {int(item['pts_mask'].sum())} "
        f"points, keys {sorted(item)}")

    # E1 on view 0's maps and V1 on its volume, as generate_view builds
    # them
    maps = device_maps(projections_png["REST"], device)
    e1_use = e1_measure("dataset view", maps, include_btm=False)
    e1_use["launches"] = e1_launches
    e1_use["stage_ms"] = stages["extrude (E1, maps uploaded)"]
    pts = dg.get_points_from_projections("GOOGLE_EARTH", projections_png,
                                         device=device)
    offsets = pts[:, :3].min(0).values - torch.tensor(
        [0, 0, 1], dtype=torch.int32, device=device)
    ids = torch.arange(1, len(pts) + 1, dtype=torch.int32, device=device)
    vol = vis.points_to_volume(pts[:, :3] - offsets, ids,
                               pts[:, 3:4].expand(-1, 3), *vol_shape)
    occ = vis.pack_occupancy(vol)
    f32 = dict(dtype=torch.float32, device=device)
    rays = vis.world_ray_basis(
        torch.tensor([p0["tx"], p0["ty"], p0["tz"]], **f32),
        torch.tensor([p0["qx"], p0["qy"], p0["qz"], p0["qw"]], **f32),
        offsets)
    K = dg.camera_intrinsics("GOOGLE_EARTH")
    W, H = dg.sensor_size("GOOGLE_EARTH")
    use = v1_measure("dataset view", vol, occ, rays, float(K[0, 0]),
                     (float(K[1, 2]), float(K[0, 2])), (H, W))
    use["launches"] = launches
    use["view_ms"] = wall / n
    return city, use, e1_use


GE_OSM_SIZE = 2560  # the OSM render: the 2048-pixel window and a margin
GE_BUILDINGS = 320
GE_VIEWS = 4
GE_LNGLAT = (10.0, 45.0)  # the capture's target
KITTI_VOL = (256, 256, 128)


def web_mercator_lnglat(x, y, resolution: float = 1.0):
    """The inverse of ``camera_recovery.lnglat_to_web_mercator_xy``."""
    from gaussiancity_tpu_torch.data.camera_recovery import (
        GOOGLE_EARTH_ZOOM_LEVEL)

    world = (2.0 ** GOOGLE_EARTH_ZOOM_LEVEL) * 256 * resolution
    lng = x / world * 360.0 - 180.0
    lat = np.degrees(np.arctan(np.sinh(np.pi * (1.0 - 2.0 * y / world))))
    return float(lng), float(lat)


def write_google_earth_capture(root: str, seed: int = 0
                               ) -> Tuple[str, str, str]:
    """A synthetic Google Earth capture at the real width, as the JAX
    suite's fixtures make it (``tests/test_osm_ingest.py::make_capture``,
    ``tests/test_camera_recovery.py``): an OSM render (``hf.png`` and a
    palette ``seg.png``, 2560 pixels a side) with a road lattice, a lake,
    parks and zones and 320 buildings (some under construction), its
    ``metadata.json``, and a capture directory with its Google Earth
    Studio ``.esp`` project, camera path ``.json`` (4 frames, each over
    the low corner of the 2048-pixel window and looking at its centre, so
    that the 640-pixel volume holds what the lower half of the view sees)
    and ``metadata.json``.  Returns (data dir, OSM dir, capture dir)."""
    from PIL import Image

    from gaussiancity_tpu_torch.data.camera_recovery import (
        lnglat_to_web_mercator_xy)
    from gaussiancity_tpu_torch.data.dataset_generator import CLASSES

    cls = CLASSES["GOOGLE_EARTH"]
    rng = np.random.default_rng(seed)
    P = GE_OSM_SIZE
    seg = np.full((P, P), cls["GREEN_LANDS"], np.uint8)
    for _ in range(40):
        y, x = rng.integers(0, P - 200, 2)
        seg[y:y + rng.integers(40, 200), x:x + rng.integers(40, 200)] = \
            cls["ZONE"]
    hf = np.full((P, P), 2, np.uint16)
    seg[1500:1800, 300:900] = cls["WATER"]
    hf[1500:1800, 300:900] = 0
    for b in range(GE_BUILDINGS):
        y, x = rng.integers(8, P - 80, 2)
        h, w = rng.integers(12, 60, 2)
        seg[y:y + h, x:x + w] = (cls["CONSTRUCTION"] if b % 16 == 0
                                 else cls["BLDG_FACADE"])
        hf[y:y + h, x:x + w] = rng.integers(15, 120)
    for c in range(40, P, 256):  # the road lattice, over everything
        for sl in (np.s_[c:c + 20, :], np.s_[:, c:c + 20]):
            seg[sl] = cls["ROAD"]
            hf[sl] = 2
    city_name, project = "Synthetic-01", "Synthetic-01-capture"
    osm_dir = os.path.join(root, "osm")
    osm = os.path.join(osm_dir, city_name)
    os.makedirs(osm)
    img = Image.fromarray(seg, mode="P")
    img.putpalette(list(rng.integers(0, 255, 768, np.uint8)))
    img.save(os.path.join(osm, "seg.png"))
    Image.fromarray(hf).save(os.path.join(osm, "hf.png"))
    lng, lat = GE_LNGLAT
    X, Y = lnglat_to_web_mercator_xy(lng, lat, 1.0)
    with open(os.path.join(osm, "metadata.json"), "w") as fp:
        json.dump({"resolution": 1.0, "bounds": {
            "xmin": float(X) - P / 2, "ymin": float(Y) - P / 2}}, fp)

    data_dir = os.path.join(root, "google-earth")
    cap = os.path.join(data_dir, project)
    os.makedirs(cap)
    esp = {"scenes": [{"attributes": [
        {"type": "cameraGroup", "attributes": [
            {"type": "cameraTargetEffect", "attributes": [
                {"type": "poi", "attributes": [
                    {"type": "longitudePOI",
                     "value": {"relative": (lng + 180.0) / 360.0}},
                    {"type": "latitudePOI", "value": {"relative": 0.4}},
                    {"type": "altitudePOI", "value": {"relative": 6.0}},
                ]}]}]}]}]}
    with open(os.path.join(cap, f"{project}.esp"), "w") as fp:
        json.dump(esp, fp)
    with open(os.path.join(cap, "metadata.json"), "w") as fp:
        json.dump({"clat": lat, "elevation": 5}, fp)
    frames = []
    for i in range(GE_VIEWS):
        # window pixel (150 + 60 i, 200 + 40 i) at 180 + 5 i over ground
        f_lng, f_lat = web_mercator_lnglat(float(X) - 1024 + 150 + 60 * i,
                                           float(Y) - 1024 + 200 + 40 * i)
        frames.append({"coordinate": {"longitude": f_lng, "latitude": f_lat,
                                      "altitude": 180.0 + 5 * i},
                       "fovVertical": 22.5})
    with open(os.path.join(cap, f"{project}.json"), "w") as fp:
        json.dump({"width": 1920, "height": 1080, "cameraFrames": frames},
                  fp)
    return data_dir, osm_dir, cap


def _kitti_box(w, d, h, offset):
    """KITTI-360 bbox corners, (bottom, top) pairs sharing XY."""
    xy = np.array([[0, 0], [w, 0], [w, d], [0, d]], float)
    out = []
    for p in xy:
        out += [[p[0], p[1], 0.0], [p[0], p[1], h]]
    return np.asarray(out) + np.asarray(offset)


def write_kitti_download(root: str) -> Tuple[str, str]:
    """A small synthetic KITTI-360 download, as
    ``tests/test_generate_dataset_cli.py::_kitti_download`` makes it: one
    drive with 3 frames (one without a semantic map, dropped), a 3D-box
    XML (a building, a road, a parked car and a stand of vegetation, so
    that the views extrude two categories), the calibration and the
    poses.  Returns (download root, drive)."""
    from PIL import Image

    from gaussiancity_tpu_torch.data import kitti_ingest as ki

    drive = "2013_05_28_drive_0000_sync"
    rgb_dir = os.path.join(root, "data_2d_raw", drive, "image_00",
                           "data_rect")
    seg_dir = os.path.join(root, "data_2d_semantics", "train", drive,
                           "image_00", "semantic")
    pose_dir = os.path.join(root, "data_poses", drive)
    calib = os.path.join(root, "calibration")
    bbox_dir = os.path.join(root, "data_3d_bboxes", "train_full")
    for d in (rgb_dir, seg_dir, pose_dir, calib, bbox_dir):
        os.makedirs(d)
    img = Image.fromarray(np.zeros((4, 4), np.uint8))
    for f in (0, 10, 20):
        img.save(os.path.join(rgb_dir, "%010d.png" % f))
    for f in (0, 10):
        img.save(os.path.join(seg_dir, "%010d.png" % f))
    rows = []
    for i, f in enumerate((0, 10, 20)):
        Rt = np.eye(4)  # [Right|Down|Forward]: looking along +y
        Rt[:3, :3] = np.stack([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]],
                              axis=-1)
        Rt[:3, 3] = [10.0, 1.0 + i, 2.0]
        rows.append(np.concatenate([[f], Rt.reshape(-1)]))
    np.savetxt(os.path.join(pose_dir, "cam0_to_world.txt"), np.array(rows))
    with open(os.path.join(calib, "perspective.txt"), "w") as fp:
        fp.write("P_rect_00: 552.554 0 682.049 0 0 552.554 238.769 0 "
                 "0 0 1 0\nS_rect_00: 1408 376\n")

    def mat(m):
        m = np.asarray(m, float)
        return (f"<rows>{m.shape[0]}</rows><cols>{m.shape[1]}</cols>"
                f"<data>{' '.join(str(x) for x in m.ravel())}</data>")

    faces = ki._prism_faces(4)
    xml = "<opencv_storage>"
    for k, (label, box) in enumerate((
            ("building", _kitti_box(4, 6, 9, (0, 4, 0.5))),
            ("road", _kitti_box(20, 3, 0.8, (0, 10, 0.9))),
            ("car", _kitti_box(2, 4, 1.6, (14, 6, 0.5))),
            ("vegetation", _kitti_box(3, 3, 1.5, (5, 14, 0.5))))):
        xml += (f"<object{k}><label>{label}</label><dynamic>0</dynamic>"
                f"<start_frame>0</start_frame><end_frame>100</end_frame>"
                f"<transform>{mat(np.eye(4))}</transform>"
                f"<vertices>{mat(box)}</vertices>"
                f"<faces>{mat(faces)}</faces></object{k}>")
    with open(os.path.join(bbox_dir, f"{drive}.xml"), "w") as fp:
        fp.write(xml + "</opencv_storage>")
    return root, drive


def phase_raw_capture(e1: dict, device="cuda") -> None:
    """From raw capture to training city on the card: the port's
    ``process_city`` over a synthetic Google Earth capture at the real
    width (``google_earth_projections`` at MAP_SIZE 2048, the poses, 4
    views at 640 x 640 x 256; E1 once a view, the split of a view's time),
    E1 held against its plain version on the 2048-pixel REST map (and on a
    repeat) and timed beside the host extruders (NumPy and g++, wall
    clock), one ``GoogleEarthDataset`` item read back; then a small
    KITTI-360 drive through ``process_city`` on the card and on the CPU,
    whose Points pkls and instance images must be equal.  Adds E1's
    ``ge_2048`` use to ``e1``."""
    import torch
    from PIL import Image

    from gaussiancity_tpu_torch.data import dataset_generator as dg
    from gaussiancity_tpu_torch.data import generate_dataset as gd
    from gaussiancity_tpu_torch.data import kitti_ingest as ki
    from gaussiancity_tpu_torch.data.datasets import get_dataset
    from gaussiancity_tpu_torch.native import extrude_points_native
    from gaussiancity_tpu_torch.ops import extrusion as ext
    from gaussiancity_tpu_torch.ops import visibility as vis

    root = os.path.join(cli_root(), "raw")
    t0 = time.perf_counter()
    data_dir, osm_dir, cap = write_google_earth_capture(root)
    log(f"synthetic Google Earth capture ({GE_OSM_SIZE}-pixel OSM render, "
        f"{GE_BUILDINGS} buildings, {GE_VIEWS} frames) written in "
        f"{time.perf_counter() - t0:.1f} s")
    targets = view_targets() + [(ki, "get_projections"),
                                (gd, "recover_camera_parameters"),
                                (dg, "dump_projections")]
    vis.raycast.launches = 0
    ext.extrude_rows.launches = 0
    with timed_calls(targets) as t:
        t0 = time.perf_counter()
        gd.process_city("GOOGLE_EARTH", cap, osm_dir, DATASET_VOL,
                        device=device)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = ext.extrude_rows.launches
    check(launches == GE_VIEWS and vis.raycast.launches == GE_VIEWS,
          f"process_city launched E1 {launches} and V1 "
          f"{vis.raycast.launches} times for {GE_VIEWS} views")
    ingest = (t["get_projections"][0] + t["recover_camera_parameters"][0]
              + t["dump_projections"][0])
    log(f"process_city (Google Earth, MAP_SIZE 2048): {wall / 1e3:.2f} s; "
        f"ingest {t['get_projections'][0]:.1f} ms, poses "
        f"{t['recover_camera_parameters'][0]:.1f} ms, projection PNGs "
        f"{t['dump_projections'][0]:.1f} ms")
    stages = log_view_stages(t, wall - ingest, GE_VIEWS,
                             f"Google Earth views (960x540 over a "
                             f"{DATASET_VOL} volume)")

    maps_np = dg.load_projections(os.path.join(cap, "Projection"))["REST"]
    check(maps_np["INS"].shape == (2048, 2048) and set(maps_np) == {
        "INS", "SEG", "TD_HF", "BU_HF", "PTS"},
        "google_earth_projections did not make the 2048-pixel maps")
    maps = device_maps(maps_np, device)
    use = e1_measure("Google Earth 2048", maps, include_btm=False)
    use["launches"] = launches
    use["stage_ms"] = stages["extrude (E1, maps uploaded)"]
    e1.setdefault("uses", {})["ge_2048"] = use
    card_rows = ext.extrude_points_exact(
        *maps, dg.get_seg_ins_relations("GOOGLE_EARTH"),
        dg.class_scale_table("GOOGLE_EARTH"), False).cpu().numpy()
    host = [maps_np[k].astype(np.int32) for k in ("INS", "TD_HF", "BU_HF")]
    host.append(maps_np["PTS"] != 0)
    host_args = (*host, dg.get_seg_ins_relations("GOOGLE_EARTH"),
                 dg.class_scale_table("GOOGLE_EARTH"), False)
    t0 = time.perf_counter()
    np_rows = ext.extrude_points_np(*host_args)
    use["numpy_ms"] = (time.perf_counter() - t0) * 1e3
    extrude_points_native(*host_args)  # builds the library
    t0 = time.perf_counter()
    native_rows = extrude_points_native(*host_args)
    use["native_ms"] = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(np_rows, card_rows)
          and np.array_equal(native_rows, card_rows),
          "the host extruders differ from E1 on the 2048-pixel map")
    log(f"host extruders on the same map, the same {len(card_rows)} rows: "
        f"NumPy {use['numpy_ms']:.1f} ms, g++ ({os.cpu_count()} cores, "
        f"{min(os.cpu_count() or 1, 8)} threads) {use['native_ms']:.1f} ms, "
        f"wall clock; E1 {use['ms']:.4f} ms a call on the card")

    os.makedirs(os.path.join(cap, "footage"))
    rng = np.random.default_rng(0)
    name = os.path.basename(cap)
    for i in range(GE_VIEWS):
        Image.fromarray(rng.integers(0, 255, (540, 960, 3), np.uint8)).save(
            os.path.join(cap, "footage", f"{name}_{i:02d}.jpeg"))
    cfg = cli_config(data_dir, os.path.join(cli_root(), "out_raw"))
    cfg = cfg.replace(dataset=cfg.dataset.replace(
        n_views=GE_VIEWS, map_size=dg.CONSTANTS["GOOGLE_EARTH"]["MAP_SIZE"],
        test_crop_size=(960, 540)))
    item = get_dataset(cfg, "GOOGLE_EARTH", "val")[0]
    check(item["rgb"].shape == (540, 960, 3)
          and item["proj_hf"].shape == (cfg.dataset.proj_size,) * 2 + (1,)
          and item["pts_mask"].sum() > 0,
          "GoogleEarthDataset cannot read the city made from the capture")
    log(f"GoogleEarthDataset val item 0 of the capture's city: "
        f"{int(item['pts_mask'].sum())} points")

    # KITTI-360: the same drive on the card and on the CPU
    cities = {}
    for i, dev in enumerate((device, "cpu")):
        r, drive = write_kitti_download(os.path.join(root, f"kitti_{i}"))
        city = os.path.join(ki.reorganize_kitti_360(r), drive)
        ext.extrude_rows.launches = 0
        t0 = time.perf_counter()
        gd.process_city("KITTI_360", city, vol_shape=KITTI_VOL, device=dev)
        n_cat = len(dg.load_projections(os.path.join(city, "Projection")))
        n_views = len(os.listdir(os.path.join(city, "Points")))
        log(f"KITTI-360 drive on {dev}: {n_views} views of {n_cat} "
            f"categories at {KITTI_VOL} in {time.perf_counter() - t0:.1f} "
            f"s; E1 launches {ext.extrude_rows.launches}")
        if dev != "cpu":
            check(ext.extrude_rows.launches == n_views * n_cat
                  and n_views == 2 and n_cat == 2,
                  "the KITTI-360 views did not launch E1 once a category "
                  "a view")
        cities[dev] = city
    for sub in ("Points", "InstanceImage"):
        names = sorted(os.listdir(os.path.join(cities["cpu"], sub)))
        check(names == sorted(os.listdir(os.path.join(cities[device], sub))),
              f"the KITTI-360 {sub} files differ between card and CPU")
        for f in names:
            a, b = (os.path.join(cities[d], sub, f) for d in (device, "cpu"))
            if sub == "Points":
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    pa, pb = pickle.load(fa), pickle.load(fb)
                check(pa.keys() == pb.keys() and all(
                    pa[k].dtype == pb[k].dtype and np.array_equal(pa[k], pb[k])
                    for k in ("vpm", "msk", "pts")) and all(
                    np.array_equal(pa["prj"][k], pb["prj"][k])
                    for k in pb["prj"]) and len(pa["pts"]) > 0,
                    f"KITTI-360 {f}: the card's pkl differs from the CPU's")
            else:
                with Image.open(a) as ia, Image.open(b) as ib:
                    check(np.array_equal(np.array(ia), np.array(ib)),
                          f"KITTI-360 {f}: the card's instance map differs")
    log("KITTI-360: the card's Points pkls and instance images equal the "
        "CPU's")


def run_cli(args, what: str, device: str) -> Tuple[str, float]:
    """``python3 -m gaussiancity_tpu_torch <args> --device <device>`` as a
    subprocess of this run, from the repository root; fails the run unless
    it exits 0 on that device.  Returns (its standard output and error,
    wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gaussiancity_tpu_torch", *args, "--device",
         device],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        log(f"{what} failed; the end of its output:\n{text[-4000:]}")
    check(proc.returncode == 0, f"{what} exited {proc.returncode}")
    check(f"device: {device}" in text, f"{what} did not run on {device}")
    return text, wall


def phase_cli_train(root: str, device="cuda") -> None:
    """The CLI's train mode (4 steps of the tiny REST widths on the
    generated city) and its ``--test`` mode on that checkpoint, each a
    subprocess on the card."""
    import re

    from gaussiancity_tpu_torch.training import checkpoint

    out_dir = os.path.join(cli_root(), "out")
    cfg = cli_config(root, out_dir)
    cfg_path = os.path.join(cli_root(), "tiny_rest.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    common = ["-r", "rest", "-d", "GOOGLE_EARTH", "-c", cfg_path]
    text, train_s = run_cli(common + ["-e", cfg.exp_name, "--max-steps",
                                      "4"], "the CLI's train mode", device)
    ckpt_dir = os.path.join(out_dir, "ckpt", cfg.exp_name)
    check(checkpoint.latest_epoch(ckpt_dir) == 1,
          "the CLI's train mode wrote no epoch-1 checkpoint")
    with open(os.path.join(out_dir, "logs", cfg.exp_name,
                           "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["Loss/Batch/GenLoss"] for r in rows
              if "Loss/Batch/GenLoss" in r]
    check(len(losses) == 4 and np.isfinite(losses).all(),
          f"the CLI's train mode logged {len(losses)} step losses")
    counters = {k: max(r[k] for r in rows if k in r) for k in (
        "Raster/Batch/RasterDroppedPairs", "Raster/Batch/RasterTruncated",
        "Raster/Batch/RasterGradTruncated", "Raster/Batch/PTv3PoolOverflow")}
    check(not any(counters.values()),
          f"the CLI's train mode overflowed: {counters}")
    epoch_s = float(re.search(r"\[Epoch 1/1\] done in ([0-9.]+)s",
                              text).group(1))
    for line in text.splitlines():
        if "BatchTime" in line:
            log("  CLI train: " + line.split("] ", 1)[-1])
    text, test_s = run_cli(common + ["--test", "-p", ckpt_dir],
                           "the CLI's --test mode", device)
    val = float(re.search(r"\[Val\]\[Epoch 1\] L1Loss (\S+)", text).group(1))
    check(np.isfinite(val), "the CLI's --test mode gave no finite L1")
    log(f"CLI train mode: 4 steps, epoch {epoch_s:.2f} s "
        f"({4 / epoch_s:.3f} steps/s, validation and checkpoint apart), "
        f"process {train_s:.2f} s; GenLoss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; overflow counters {counters}")
    log(f"CLI --test mode: val L1 {val:.5f}, process {test_s:.2f} s")


def phase_cli_inference(city: str, ckpt_dirs: dict, device="cuda") -> dict:
    """The CLI's ``--inference`` from the REST and BLDG checkpoints over
    the generated city (a subprocess on the card), against an in-process
    ``InferencePipeline`` from ``get_models`` of the same directories with
    the same poses, style table and budgets: the jpgs byte-equal, K1, V1
    and G1 on every in-process frame (counts set to 0 just before); then
    the first frame once more with the arguments of its K1, V1 and G1
    calls kept, and each kernel held against its plain version on them.
    Returns each kernel's "cli_frame" use entry."""
    import re
    import tempfile

    import cv2
    import torch

    from gaussiancity_tpu_torch import run
    from gaussiancity_tpu_torch.inference.loader import (
        get_city_projections, get_models)
    from gaussiancity_tpu_torch.inference.pipeline import (
        InferencePipeline, get_orbit_camera_poses, get_style_lut)
    from gaussiancity_tpu_torch.ops import hash_grid
    from gaussiancity_tpu_torch.ops import visibility as vis
    from gaussiancity_tpu_torch.ops.rasterizer import blend

    video = os.path.join(cli_root(), "video", "orbit.mp4")
    t_spawn = time.time()
    text, wall = run_cli(["--inference", "--ckpt-rest", ckpt_dirs["REST"],
                          "--ckpt-bldg", ckpt_dirs["BLDG"], "--city-dir",
                          city, "--frames", str(CLI_FRAMES), "--output",
                          video], "the CLI's --inference mode", device)
    tm = json.loads(re.search(r"inference timings: (\{.*\})",
                              text).group(1))
    jpg_dir = run.frame_dir(video)
    jpgs = sorted(os.listdir(jpg_dir))
    check(os.path.getsize(video) > 0
          and jpgs == [f"{i:04d}.jpg" for i in range(CLI_FRAMES)],
          "the CLI wrote no video or not one jpg a frame")
    log(f"CLI --inference: {CLI_FRAMES} frames in {wall:.2f} s of process: "
        f"start-up (interpreter and imports; the kernels, built by phase 1, "
        f"load at their first launch) {tm['imports_wall_time'] - t_spawn:.2f}"
        f" s, checkpoint load {tm['checkpoint_load_s']:.3f} s, projections "
        f"and centres {tm['projections_s']:.3f} s, set-up extrude "
        f"{tm['extrude_ms']:.1f} ms + volume {tm['volume_ms']:.1f} ms, "
        f"median frame {tm['frame_ms_median']:.2f} ms (frames "
        f"{[round(m, 2) for m in tm['frame_ms']]}), video write "
        f"{tm['video_write_s']:.3f} s, jpg writes {tm['jpg_write_s']:.3f} s,"
        f" peak device memory {tm['peak_device_gib']} GiB")

    # as the CLI does: its default budget for each model, the orbit of the
    # default seed around the map's centre
    cfg, models, _ = get_models(ckpt_dirs, device=device)
    projections, centers = get_city_projections(city)
    budgets = {name: 262144 for name in models}
    pipe = InferencePipeline(cfg, models, max_points=262144,
                             class_budgets=budgets, device=device)
    H, W = projections["REST"]["SEG"].shape
    poses = get_orbit_camera_poses(max(H, W), n_points=CLI_FRAMES,
                                   rng=np.random.default_rng(0),
                                   center=(W // 2, H // 2))
    lut = get_style_lut(centers, models["BLDG"].cfg.z_dim, seed=0)
    blend.blend_forward.launches = 0
    vis.raycast.launches = 0
    hash_grid.hash_encode_fwd.launches = 0
    frames = pipe.render_trajectory(projections, centers, poses,
                                    style_lut=lut)
    launches = {"blend_fwd": blend.blend_forward.launches,
                "raycast": vis.raycast.launches,
                "hash_encode_fwd": hash_grid.hash_encode_fwd.launches}
    for name, count in launches.items():
        check(count >= CLI_FRAMES,
              f"kernel {name} was not launched on every in-process frame")
    with tempfile.TemporaryDirectory(dir=cli_root()) as tmp:
        for i, f in enumerate(frames):
            path = os.path.join(tmp, f"{i:04d}.jpg")
            check(cv2.imwrite(path, f[..., ::-1]), "cv2 wrote no jpg")
            with open(path, "rb") as a, open(os.path.join(jpg_dir, jpgs[i]),
                                             "rb") as b:
                check(a.read() == b.read(), f"the CLI's frame {i} differs "
                      "from the in-process pipeline's")
    log(f"CLI frames byte-equal (jpg) to the in-process pipeline's from the "
        f"same checkpoints; in-process launches {launches}; buckets (REST, "
        f"BLDG) {[(st['n_REST'], st['n_BLDG']) for st in pipe.frame_stats]};"
        f" frame std {[round(float(f.std()), 2) for f in frames]}")
    check(all(float(f.std()) > 1 for f in frames), "a CLI frame is empty")
    del frames

    # the kernels at the shapes the CLI's frames give them
    captured = capture_calls(
        [(blend, "blend_forward"), (vis, "raycast"),
         (hash_grid, "hash_encode_fwd")],
        lambda: pipe.render_trajectory(projections, centers, poses[:1],
                                       style_lut=lut))
    check(all(len(a) == 1 for a in captured.values()),
          "the CLI's frame must call K1, V1 and G1 once each: "
          f"{ {k: len(v) for k, v in captured.items()} }")
    k1 = k1_measure("CLI frame", captured["blend_forward"][0])
    vol, rays, cam_f, cam_c, img_dims, occ = captured["raycast"][0]
    v1 = v1_measure("CLI frame", vol, occ, rays, cam_f, cam_c, img_dims)
    g1 = g1_use(phase_g1("CLI frame, REST bucket",
                         captured["hash_encode_fwd"][0]))
    uses = {"blend_fwd": k1, "raycast": v1, "hash_encode_fwd": g1}
    for name, use in uses.items():
        use["launches"] = launches[name]
    del pipe, models, captured, vol, rays, occ
    torch.cuda.empty_cache()
    return uses


# ---------------------------------------------------------------------------
# the model-surface options: bf16 compute, batch size 2, LOCAL, PTv3
# options, the oracle renderer, debug snapshots
# ---------------------------------------------------------------------------

BF16_ULP = 2.0 ** -8
# bf16 steps card vs CPU: each tensor within 4 bf16 ulps of its largest
# value, or within three times the distance of the CPU's bf16 result from
# its float32 result.  That distance measures the bf16 rounding noise;
# the card and the CPU each carry their own (they round after sums taken
# in other orders), so their difference reaches about twice it, and the
# largest entry of a second sample of it somewhat more
BF16_STEP_ULPS = 4
BF16_STEP_NOISE = 3
# the first step's generator loss, card vs CPU in bf16, within this share
# of the CPU's bf16-to-float32 distance: the forward rounds at the same
# ops on both (measured ~0.003 of it), where a step in another precision
# lands about the whole distance away (the control in phase 20)
BF16_FWD_SHARE = 0.25
PTV3_FWD_RTOL = 1e-4  # small PTv3 forwards card vs CPU, of the largest


def bf16_config(cfg):
    """``cfg`` with the generator and D / VGG computing in bfloat16."""
    return cfg.replace(
        network=cfg.network.replace(compute_dtype="bfloat16"),
        train=cfg.train.replace(compute_dtype="bfloat16"))


def local_config(cfg):
    """``cfg`` with the LOCAL encoder in place of the GLOBAL one."""
    return cfg.replace(network=cfg.network.replace(encoder="LOCAL"))


def city_projection_maps(batch, projections, n_classes: int):
    """The batch's projection maps filled with the synthetic city's
    height field and segmentation, resampled (nearest) to the batch's map
    size, and ``proj_tlp`` set so that the map's centre lies under the
    camera: the LOCAL encoder then gives each point its own encoder
    dimensions."""
    import torch

    r = projections["REST"]
    P = batch["proj_hf"].shape[1]
    pick = np.arange(P) * r["TD_HF"].shape[0] // P
    hf = r["TD_HF"][np.ix_(pick, pick)].astype(np.float32)
    seg = r["SEG"][np.ix_(pick, pick)] % n_classes
    dev = batch["pts"].device
    out = dict(batch)
    out["proj_hf"] = torch.as_tensor(hf[None, :, :, None], device=dev)
    out["proj_seg"] = torch.nn.functional.one_hot(
        torch.as_tensor(seg[None], device=dev).long(), n_classes).float()
    out["proj_tlp"] = torch.full((1, 2), -P / 2, device=dev)
    return out


def step_runs(cfg, make_batch, devices, seed: int, n_steps: int = 2):
    """``n_steps`` train steps of ``cfg`` from the same seeded weights on
    each device: per device, per step, (losses, gradients of G and D)."""
    from gaussiancity_tpu_torch.models import ptv3
    from gaussiancity_tpu_torch.training.step import Trainer

    runs = {}
    for dev in devices:
        trainer = Trainer(cfg, device=dev, seed=seed)
        ptv3.no_drop_path(trainer.generator)
        batch = make_batch(dev)
        steps = []
        for _ in range(n_steps):
            m = {k: float(v) for k, v in trainer.train_step(batch).items()}
            steps.append((m, {f"{n}.{k}": p.grad.detach().cpu().clone()
                              for n, mod in (("G", trainer.generator),
                                             ("D", trainer.discriminator))
                              for k, p in mod.named_parameters()}))
        runs[dev] = steps
    return runs


def bf16_step_faults(card, cpu, cpu32) -> Tuple[List[str], float, str]:
    """The limits that bf16 steps on the card break against the CPU's
    (``BF16_STEP_ULPS``, ``BF16_STEP_NOISE``, ``BF16_FWD_SHARE``), the
    noise measured by the CPU's float32 steps: (faults, worst gradient
    error over its tolerance, where)."""
    faults, worst, worst_name = [], 0.0, ""
    for i, ((m_a, g_a), (m_b, g_b), (m_f, g_f)) in enumerate(
            zip(card, cpu, cpu32)):
        for k, v in m_b.items():
            tol = max(1e-2 * abs(v), BF16_STEP_NOISE * abs(v - m_f[k]),
                      1e-6)
            if not (np.isfinite(m_a[k]) and abs(m_a[k] - v) <= tol):
                faults.append(f"step {i} {k}: card {m_a[k]} vs CPU {v}")
        if i == 0:
            noise = abs(m_b["GenLoss"] - m_f["GenLoss"])
            err = abs(m_a["GenLoss"] - m_b["GenLoss"])
            log(f"  step 0 GenLoss card vs CPU {err:.3e}, "
                f"{err / noise:.4f} of the bf16-to-float32 distance "
                f"{noise:.3e} (limit {BF16_FWD_SHARE})")
            if not (noise > 1e-5 * abs(m_f["GenLoss"])
                    and err <= BF16_FWD_SHARE * noise):
                faults.append(f"step 0 GenLoss: card {m_a['GenLoss']} vs "
                              f"CPU {m_b['GenLoss']}, float32 "
                              f"{m_f['GenLoss']}")
        for name, want in g_b.items():
            noise = float((want - g_f[name]).abs().max())
            scale = float(want.abs().max())
            err = float((g_a[name] - want).abs().max())
            tol = max(BF16_STEP_ULPS * BF16_ULP * scale,
                      BF16_STEP_NOISE * noise)
            if tol > 0 and err / tol > worst:
                worst, worst_name = err / tol, f"step {i} {name}"
            if not err <= tol:
                faults.append(f"step {i} gradient {name}: max|d| "
                              f"{err:.3e}, bf16 noise {noise:.3e}, scale "
                              f"{scale:.3e}")
    return faults, worst, worst_name


def check_bf16_steps(what: str, card, cpu, cpu32, card32) -> None:
    """bf16 steps on the card against the CPU's within every limit of
    ``bf16_step_faults``; and, as a control, the card's float32 steps
    against the CPU's bf16 ones must break one."""
    faults, worst, worst_name = bf16_step_faults(card, cpu, cpu32)
    for (m_a, _), (m_b, _), (m_f, _) in zip(card, cpu, cpu32):
        log(f"{what} card vs CPU: GenLoss {m_a['GenLoss']:.6f} / "
            f"{m_b['GenLoss']:.6f} (float32 {m_f['GenLoss']:.6f}), DisLoss "
            f"{m_a['DisLoss']:.6f} / {m_b['DisLoss']:.6f}")
    check(not faults, f"{what} card vs CPU: {faults[:3]}")
    log(f"{what} gradients card vs CPU: worst max|d| / tolerance "
        f"{worst:.3f} ({worst_name})")
    log(f"{what} control, float32 steps on the card against the CPU's "
        "bf16:")
    control, _, _ = bf16_step_faults(card32, cpu, cpu32)
    log(f"{what} control breaks {len(control)} limits: {control[:3]}")
    check(len(control) > 0, f"{what}: the card's float32 steps pass the "
          "bf16 limits: they cannot tell the precision")


def tiny_bldg_batch2(cfg, dev):
    """Two tiny BLDG samples, the second with a quarter of its rows
    masked and its camera moved."""
    import torch

    from gaussiancity_tpu_torch.testing import tiny_bldg_batch

    one, two = (tiny_bldg_batch(cfg, 256, seed=s) for s in (4, 5))
    batch = {k: np.concatenate([one[k], two[k]]) for k in one}
    batch["pts_mask"][1, 192:] = False
    batch["cam_pos"][1] = [0.0, 0.5, 0.0]
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def phase_small_surface(device, projections):
    """The model-surface options at tiny widths, card against CPU: a bf16
    REST step and a bf16 BLDG step at batch size 2 (held to the CPU
    within the bf16 noise that the CPU's float32 steps measure), a LOCAL
    REST step (float32, phase 8's tolerances), the small PTv3 with
    ``enable_rpe`` and with the sorted-merge search, ``naive_render``
    against ``rasterize`` (K1), and ``rasterize_checked`` on a NaN colour
    and a NaN mean."""
    import torch

    from gaussiancity_tpu_torch.config import PTv3Config
    from gaussiancity_tpu_torch.models import ptv3
    from gaussiancity_tpu_torch.ops.rasterizer import blend, debug
    from gaussiancity_tpu_torch.ops.rasterizer import rasterize
    from gaussiancity_tpu_torch.ops.rasterizer.naive import naive_render
    from gaussiancity_tpu_torch.testing import TINY_PTV3
    from gaussiancity_tpu_torch.utils import helpers

    rest = tiny_train_config()

    def rest_batch(dev):
        return synthetic_rest_batch(rest, 256, seed=4, device=dev)

    runs = step_runs(bf16_config(rest), rest_batch, (device, "cpu"), 3)
    ref = step_runs(rest, rest_batch, (device, "cpu"), 3)
    check_bf16_steps("tiny bf16 REST", runs[device], runs["cpu"],
                     ref["cpu"], ref[device])

    bldg = tiny_bldg_config()
    bldg = bldg.replace(train=bldg.train.replace(batch_size=2))
    table = torch.randn((helpers.MAX_N_INSTANCES, 16),
                        generator=torch.Generator().manual_seed(7))
    get_z = helpers.get_z
    helpers.get_z = lambda gen, ins, z_dim: table.to(ins.device)[
        ins.long() % table.shape[0]]
    try:
        def b2(dev):
            return tiny_bldg_batch2(bldg, dev)
        runs = step_runs(bf16_config(bldg), b2, (device, "cpu"), 3)
        ref = step_runs(bldg, b2, (device, "cpu"), 3)
    finally:
        helpers.get_z = get_z
    check_bf16_steps("tiny bf16 BLDG B=2", runs[device], runs["cpu"],
                     ref["cpu"], ref[device])

    local = local_config(rest)
    runs = phase_small_train(
        device, local, lambda dev: city_projection_maps(
            rest_batch(dev), projections, local.dataset.n_classes),
        "tiny LOCAL step")
    enc = runs["cpu"][0][1]["G.proj_encoder.hf_conv.weight"]
    check(float(enc.abs().max()) > 0,
          "the tiny LOCAL step gives its encoder no gradient")

    rng = np.random.default_rng(8)
    feat = rng.normal(size=(1, 300, 6)).astype(np.float32)
    coord = rng.uniform(-0.2, 0.2, (1, 300, 3)).astype(np.float32)
    outs = {}
    for change in ("rpe", "sorted_merge", "dense"):
        kw = {"rpe": dict(enable_rpe=True),
              "sorted_merge": dict(dense_nbr_extent=0)}.get(change, {})
        torch.manual_seed(0)
        model = ptv3.PointTransformerV3(PTv3Config(**TINY_PTV3, **kw), 6)
        for m in model.modules():
            if isinstance(m, ptv3.PatchAttention) and change == "rpe":
                with torch.no_grad():
                    m.rpe_table.normal_(0, 0.5)
        for dev in (device, "cpu"):
            with torch.no_grad():
                outs[change, dev] = model.to(dev).eval()(
                    torch.as_tensor(feat, device=dev),
                    torch.as_tensor(coord, device=dev)).cpu()
        err = float((outs[change, device] - outs[change, "cpu"]).abs().max())
        scale = float(outs[change, "cpu"].abs().max())
        log(f"small PTv3 ({change}) card vs CPU: max|d| {err:.3e} of "
            f"{scale:.3e}")
        check(err <= PTV3_FWD_RTOL * scale and scale > 0.1,
              f"small PTv3 ({change}) card vs CPU: max|d| {err:.3e}")
    check(torch.equal(outs["sorted_merge", device], outs["dense", device]),
          "the sorted-merge search gives another PTv3 output than the "
          "dense one on the card")
    check(float((outs["rpe", "cpu"] - outs["dense", "cpu"]).abs().max())
          > 1e-3, "the RPE table changed nothing")

    cam, scene = small_scene(device)
    rc = small_config().rasterizer
    n0 = blend.blend_forward.launches
    out = rasterize(*scene, cam, rc)
    img, final_T = naive_render(*scene, cam, rc)
    torch.cuda.synchronize()
    err = max(float((out.image - img).abs().max()),
              float((out.final_T - final_T).abs().max()))
    log(f"naive_render vs rasterize (K1) on the card: max|d| {err:.3e}, "
        f"image std {float(img.std()):.3f}")
    check(blend.blend_forward.launches == n0 + 1,
          "rasterize did not launch K1")
    check(err <= K1_TOL and float(img.std()) > 0.01,
          "naive_render disagrees with rasterize on the card")
    path = os.path.join(cli_root(), "snapshot_fw.pkl")
    nan_mean = [a.clone() for a in scene]
    nan_mean[0][0, 1] = float("nan")
    out = debug.rasterize_checked(*nan_mean, cam, rc, snapshot_path=path)
    check(int(out.radii[0]) == 0 and not os.path.exists(path),
          "a NaN mean must be culled, with no snapshot")
    scene[4] = scene[4].clone()
    scene[4][0, 1] = float("nan")
    try:
        debug.rasterize_checked(*scene, cam, rc, snapshot_path=path)
        check(False, "rasterize_checked did not raise on a NaN colour")
    except FloatingPointError as e:
        log(f"rasterize_checked on a NaN colour raised: {e}")
    snap = debug.load_snapshot(path)
    check(np.isnan(snap["arrays"]["colors"][0, 1])
          and snap["cam"].view_matrix.device.type == "cpu",
          "the snapshot does not hold the render's inputs")
    log(f"snapshot: {sorted(snap['arrays'])}, {os.path.getsize(path)} B")


def small_scene(device):
    """64 seeded Gaussians in front of small_config()'s 128x64 camera."""
    import torch

    from gaussiancity_tpu_torch.camera import CameraModel

    ds = small_config().dataset
    cam = CameraModel(np.asarray(ds.cam_k).reshape(3, 3),
                      ds.sensor_size).params(
        np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]), device=device)
    rng = np.random.default_rng(9)
    n = 64
    d = rng.uniform(4.0, 20.0, n)
    arrays = [np.stack([d, rng.uniform(-1, 1, n) * d,
                        rng.uniform(-0.5, 0.5, n) * d], -1),
              rng.uniform(0.2, 0.9, n), rng.uniform(0.1, 0.8, (n, 3)),
              np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)), rng.uniform(0, 1, (n, 3))]
    arrays[0][0] = (6.0, 0.0, 0.0)  # Gaussian 0 in the middle of the view
    return cam, [torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in arrays]


def hash_grid_uses(captured, use: str) -> dict:
    """G1, G1b and K3 (both uses) against their plain versions on one
    captured REST step: their use entries by kernel name."""
    g1 = g1_use(phase_g1(use, captured["hash_encode_fwd"][0]))
    g1b = phase_g1b(captured["hash_encode_bwd"][0])
    g1b = {k: g1b[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "distinct_rows")}
    uses = k3_uses(captured["segment_sum"], use)
    for u in uses.values():
        del u["t_bytes"], u["t_ops"]
    return {"hash_encode_fwd": g1, "hash_encode_bwd": g1b,
            "segment_sum": uses}


def add_use(kernels, name: str, use: str, entry: dict, launches: int):
    """Put ``entry`` under "uses" of kernel ``name``, with its launches
    on that use's timed pass."""
    k = next(k for k in kernels if k["name"] == name)
    k.setdefault("uses", {})[use] = {**entry, "launches": launches}


def phase_rest_bf16(kernels, batch, profiling: bool = False,
                    device="cuda") -> dict:
    """The full-width REST step in bf16 (phase 9's recipe, seed and
    batch): one step whose K1, K2, K3, G1 and G1b inputs are kept and held
    against the plain versions, then 2 warm-up and 5 timed steps
    (``--profile``: the device's busy share)."""
    import torch

    from gaussiancity_tpu_torch.training.step import Trainer

    trainer = Trainer(bf16_config(rest_train_config()), device=device,
                      seed=0)
    captured = capture_step_inputs(trainer, batch)
    entries = {"blend_fwd": k1_measure("bf16 REST step",
                                       captured["blend_fwd"]),
               "blend_bwd": k2_measure("bf16 REST step",
                                       captured["blend_bwd"]),
               **hash_grid_uses(captured, "bf16 REST step")}
    entries["blend_fwd"].pop("touched_share")
    del captured
    step = phase_train(trainer, batch)
    for name, e in entries.items():
        if name == "segment_sum":
            for kind, u in e.items():
                add_use(kernels, name, f"rest_step_bf16_{kind}", u,
                        step["segment_sum_by_use"][kind])
        else:
            add_use(kernels, name, "rest_step_bf16", e, step[name])
    if profiling:
        phase_train_profile(trainer, batch)
    del trainer
    torch.cuda.empty_cache()
    return step


def phase_bldg_b2(kernels, projections, centers, profiling: bool = False,
                  device="cuda") -> dict:
    """The full-width BLDG step at batch size 2 (building 172 and the
    next largest, each 16,384 rows with the point mask), in float32 and
    in bf16: per dtype one step whose K1, K2 and K3 inputs are held
    against the plain versions, 2 warm-up and 5 timed steps (PTv3 apart),
    the peak memory, an eval step, the device's busy share under
    ``--profile``."""
    import torch

    from gaussiancity_tpu_torch.training.step import Trainer

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = bldg_train_config()
        cfg = cfg.replace(train=cfg.train.replace(batch_size=2))
        if dtype == "bfloat16":
            cfg = bf16_config(cfg)
        trainer = Trainer(cfg, device=device, seed=1)
        parts = [building_batch(cfg, projections, centers, device, rank=r)
                 for r in (0, 1)]
        batch = stack_batches([p[0] for p in parts])
        eval_batch = stack_batches([p[1] for p in parts])
        log(f"BLDG B=2 ({dtype}): valid rows per sample "
            f"{batch['pts_mask'].sum(dim=1).tolist()}")
        tag = "bldg_step_b2_" + ("f32" if dtype == "float32" else "bf16")
        uses = phase_bldg_kernels(trainer, batch, use=f"BLDG B=2 {dtype}")
        step = phase_bldg_train(trainer, batch, eval_batch,
                                what=f"BLDG B=2 {dtype}")
        uses["blend_fwd"].pop("touched_share")
        for name, e in uses.items():
            add_use(kernels, name, tag, e,
                    step["segment_sum_by_use"]["bldg_step"]
                    if name == "segment_sum" else step[name])
        if profiling:
            phase_train_profile(trainer, batch)
        out[dtype] = step
        del trainer, batch, eval_batch, parts
        torch.cuda.empty_cache()
    return out


def phase_local_step(kernels, batch, projections, profiling: bool = False,
                     device="cuda") -> dict:
    """The full-width REST step with the LOCAL encoder on phase 9's batch
    with the city's projection maps: one step whose G1, G1b (with the
    input gradient) and K3 inputs are held against the plain versions,
    timed, with their bounds; then 2 warm-up and 5 timed steps
    (``--profile``: the device's busy share)."""
    import torch

    from gaussiancity_tpu_torch.training.step import Trainer

    cfg = local_config(rest_train_config())
    trainer = Trainer(cfg, device=device, seed=2)
    batch = city_projection_maps(batch, projections, cfg.dataset.n_classes)
    captured = capture_step_inputs(trainer, batch)
    x = captured["hash_encode_fwd"][0][0]
    spread = float(x[:, :2].std(dim=0).min())
    log(f"LOCAL step: hash-grid inputs {tuple(x.shape)}, the encoder "
        f"dimensions' spread over the points {spread:.4f}")
    check(spread > 1e-3, "the LOCAL encoder dimensions do not vary")
    entries = hash_grid_uses(captured, "LOCAL step")
    del captured
    step = phase_train(trainer, batch)
    for name, e in entries.items():
        if name == "segment_sum":
            for kind, u in e.items():
                add_use(kernels, name, f"local_step_{kind}", u,
                        step["segment_sum_by_use"][kind])
        else:
            add_use(kernels, name, "local_step", e, step[name])
    if profiling:
        phase_train_profile(trainer, batch)
    del trainer
    torch.cuda.empty_cache()
    return step


def phase_ptv3_options(projections, centers, device="cuda"):
    """PTv3 at the BLDG recipe's widths in eval on phase 14's 16,384
    points: at every neighbour search of a forward (stem, and CPE at each
    stage) the sorted-merge ``nb_idx`` and ``found`` equal to the dense
    search's where found, both searches timed; the forward with each
    search timed (outputs equal); a forward with ``enable_rpe`` (random
    table) timed, with its peak memory."""
    import torch

    from gaussiancity_tpu_torch.models import ptv3
    from gaussiancity_tpu_torch.models.generator import SinCosEncoder

    cfg = bldg_train_config()
    batch, _ = building_batch(cfg, projections, centers, device)
    rel = batch["pts"][0, :, 5:8]
    feat = SinCosEncoder(cfg.network.sin_cos_freq_bends)(rel)
    torch.manual_seed(3)
    dense = ptv3.PointTransformerV3(cfg.network.ptv3, feat.shape[1]).to(
        device).eval()
    calls = []
    search = ptv3.subm_neighbors_dense

    def keep(grid, valid, k, extent=256):
        calls.append((grid, valid, k))
        return search(grid, valid, k, extent)

    ptv3.subm_neighbors_dense = keep
    try:
        with torch.no_grad():
            out_dense = dense(feat[None], rel[None])
    finally:
        ptv3.subm_neighbors_dense = search
    rows = []
    for grid, valid, k in calls:
        nb_d, f_d, _ = search(grid, valid, k, cfg.network.ptv3.dense_nbr_extent)
        nb_s, f_s = ptv3.subm_neighbors(grid, valid, k)
        torch.cuda.synchronize()
        check(torch.equal(f_d, f_s) and torch.equal(nb_d[f_d], nb_s[f_s]),
              f"sorted-merge neighbours differ from the dense ones (k={k}, "
              f"{grid.shape[0]} points)")
        ms_d = cuda_time_ms(lambda: search(
            grid, valid, k, cfg.network.ptv3.dense_nbr_extent), iters=10)
        ms_s = cuda_time_ms(lambda: ptv3.subm_neighbors(grid, valid, k),
                            iters=10)
        rows.append((grid.shape[0], k, float(f_s.float().mean()), ms_d,
                     ms_s))
        log(f"neighbours k={k} at {grid.shape[0]} points: found share "
            f"{rows[-1][2]:.4f}, equal; dense {ms_d:.4f} ms, sorted merge "
            f"{ms_s:.4f} ms")
    check(len(calls) == 1 + len(cfg.network.ptv3.enc_depths),
          f"expected a search per stage and the stem, got {len(calls)}")
    sorted_net = ptv3.PointTransformerV3(
        cfg.network.ptv3.replace(dense_nbr_extent=0), feat.shape[1]).to(
        device).eval()
    sorted_net.load_state_dict(dense.state_dict())
    rpe = ptv3.PointTransformerV3(cfg.network.ptv3.replace(enable_rpe=True),
                                  feat.shape[1]).to(device).eval()
    rpe.load_state_dict(dense.state_dict(), strict=False)
    res = {}
    with torch.no_grad():
        out_sorted = sorted_net(feat[None], rel[None])
        check(torch.equal(out_sorted, out_dense),
              "the sorted-merge PTv3 forward differs from the dense one")
        for name, net in (("dense", dense), ("sorted_merge", sorted_net),
                          ("rpe", rpe)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = cuda_time_ms(lambda: net(feat[None], rel[None]), iters=3,
                              warmup=1)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            res[name] = (ms, peak)
            log(f"PTv3 eval forward ({name}) at {feat.shape[0]} points: "
                f"{ms:.2f} ms, peak {peak:.3f} GiB above its inputs")
        out_rpe = rpe(feat[None], rel[None])
    check(bool(torch.isfinite(out_rpe).all())
          and float((out_rpe - out_dense).abs().max()) > 1e-4,
          "the RPE forward is not finite or equals the plain one")
    return {"searches": rows, "forward": res}


def phase_bf16_frame(kernels, cfg, projections, centers, poses, lut,
                     frames_f32, f32_median: float, device="cuda") -> dict:
    """The two-model frame with both generators in bf16 (phase 11's
    weights, scene and poses): its median against phase 11's float32
    median, the per-pixel grey-level difference from phase 11's frames
    (within 1 at >= 99 % of pixels, and not all equal: a float32 frame
    would be), and K1 held against its plain version on the first
    frame's inputs (use "bf16_frame")."""
    import torch

    from gaussiancity_tpu_torch.ops.rasterizer import blend

    pipe = two_model_pipeline(cfg, device, compute_dtype="bfloat16")
    launches, _, frames = phase_two_model_frame(
        pipe, projections, centers, poses, lut, what="bf16 two-model frame")
    captured = capture_calls(
        [(blend, "blend_forward")],
        lambda: pipe.render_trajectory(projections, centers, poses[:1],
                                       style_lut=lut))
    check(len(captured["blend_forward"]) == 1,
          "the bf16 frame must call K1 once")
    k1 = k1_measure("bf16 frame", captured["blend_forward"][0])
    k1.pop("touched_share")
    add_use(kernels, "blend_fwd", "bf16_frame", k1, launches["blend_fwd"])
    del captured
    diffs = []
    for i, (a, b) in enumerate(zip(frames, frames_f32)):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        diffs.append(d)
        log(f"bf16 frame {i} vs float32: mean {float(d.mean()):.4f}, "
            f"equal {float((d == 0).mean()):.4f}, within 1 "
            f"{float((d <= 1).mean()):.4f}, within 8 "
            f"{float((d <= 8).mean()):.4f}, max {int(d.max())} grey levels")
    d = np.stack(diffs)
    log(f"two-model frame median: bf16 {launches['median_ms']:.2f} ms, "
        f"float32 {f32_median:.2f} ms (phase 11, this call)")
    check(float((d <= 1).mean()) >= 0.99,
          "the bf16 frames differ from the float32 ones by more than one "
          "grey level at over 1 % of pixels")
    check(float((d > 0).mean()) >= 0.01,
          "the bf16 frames equal the float32 ones at over 99 % of pixels: "
          "they did not compute in bf16")
    del pipe
    torch.cuda.empty_cache()
    launches.update(grey_mean=float(d.mean()),
                    grey_within1=float((d <= 1).mean()),
                    grey_max=int(d.max()))
    return launches


# ---------------------------------------------------------------------------
# phases 26-30: several ranks (``parallel``), each a spawned process
# ---------------------------------------------------------------------------

RANKS = 2
RANK_TIMEOUT_S = 420  # a rank that hangs fails its phase within this


def store_path(what: str) -> str:
    """A fresh ``FileStore`` path under the run's scratch directory."""
    path = os.path.join(cli_root(), "stores", what)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.unlink(path)
    return path


def ranks_run(fn, what: str, args=(), world: int = RANKS,
              device: str = "cuda") -> list:
    """``fn(rank, world, device, *args)`` on ``world`` spawned ranks
    (``parallel.launch.spawn_ranks``); the parent's cached device memory
    is freed first.  Fails the run if a rank fails or hangs."""
    import torch

    from gaussiancity_tpu_torch.parallel.launch import spawn_ranks

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = spawn_ranks(fn, world, store_path(what), args=args, device=device,
                      timeout_s=RANK_TIMEOUT_S)
    log(f"{what}: {world} ranks on {device} in "
        f"{time.perf_counter() - t0:.1f} s (spawn and imports included)")
    return out


def rank_setup(device) -> None:
    """A rank on the card compares with the CPU and with the parent's
    phases: TF32 off, as phase 2 sets it."""
    import torch

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def nccl_one_rank(rank, world, device):
    """Phase 26's rank: on NCCL at world size 1, a tiny REST and a tiny
    BLDG data-parallel step against ``Trainer.train_step`` of a twin
    trainer, two steps each, with PyTorch's deterministic algorithms on
    (the card's atomics would otherwise differ between any two runs).
    Returns what differs, by kind (empty when bit-equal)."""
    import torch
    import torch.distributed as dist

    from gaussiancity_tpu_torch.testing import tiny_bldg_batch
    from gaussiancity_tpu_torch.training.step import (
        Trainer, make_parallel_train_step)

    rank_setup(device)
    # cuBLAS's deterministic workspace, set before its first call
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {"backend": dist.get_backend()}
    cases = (("REST", tiny_train_config(),
              lambda cfg: synthetic_rest_batch(cfg, 256, 4, device)),
             ("BLDG", tiny_bldg_config(),
              lambda cfg: {k: torch.as_tensor(v, device=device) for k, v in
                           tiny_bldg_batch(cfg, 256, seed=4).items()}))
    for kind, cfg, make_batch in cases:
        batch = make_batch(cfg)
        a = Trainer(cfg, device=device, seed=3)
        b = Trainer(cfg, device=device, seed=3)
        step = make_parallel_train_step(a)
        diff = []
        for i in range(2):
            ma, mb = step(batch), b.train_step(batch)
            diff += [f"step {i} {k}" for k in mb
                     if float(ma[k]) != float(mb[k])]
            for part in ("generator", "discriminator"):
                ta, tb = getattr(a, part), getattr(b, part)
                sa = ta.state_dict()
                diff += [f"step {i} {part} {n}"
                         for n, v in tb.state_dict().items()
                         if not torch.equal(sa[n], v)]
                ga = dict(ta.named_parameters())
                diff += [f"step {i} {part} grad {n}"
                         for n, p in tb.named_parameters()
                         if (p.grad is None) != (ga[n].grad is None)
                         or (p.grad is not None
                             and not torch.equal(p.grad, ga[n].grad))]
        out[kind] = diff
    return out


def phase_nccl_world1() -> None:
    """Phase 26: NCCL at world size 1 on the card."""
    (r,) = ranks_run(nccl_one_rank, "NCCL world 1", world=1)
    check(r["backend"] == "nccl",
          f"one rank on its own card must take NCCL, took {r['backend']}")
    for kind in ("REST", "BLDG"):
        check(not r[kind], f"{kind} data-parallel step at world 1 differs "
              f"from Trainer.train_step: {r[kind][:8]}")
        log(f"NCCL world 1: the tiny {kind} data-parallel step equals "
            "Trainer.train_step bit for bit over 2 steps (losses, every "
            "gradient, the weights after Adam, the running state)")


def phase_small_ddp() -> None:
    """Phase 27: two ranks on the card (gloo) against two ranks on the
    CPU (gloo, plain versions): two tiny REST and two tiny BLDG steps, a
    different sample a rank.  Phase 13's limits: losses within
    STEP_LOSS_RTOL, each averaged gradient within STEP_GRAD_RTOL of its
    largest, except a generator tensor below ZERO_GRAD of the generator's
    largest gradient (rounding noise), which must be as small on the
    card."""
    from gaussiancity_tpu_torch import testing
    from gaussiancity_tpu_torch.testing import tiny_bldg_batch
    from gaussiancity_tpu_torch.utils import helpers

    rest = tiny_train_config()
    bldg = tiny_bldg_config()
    cases = {
        "REST": (rest, [{k: v.cpu().numpy() for k, v in synthetic_rest_batch(
            rest, 256, 4 + r, "cpu").items()} for r in range(RANKS)], None),
        "BLDG": (bldg, [tiny_bldg_batch(bldg, 256, seed=4 + r)
                        for r in range(RANKS)],
                 np.stack([np.random.default_rng(7 + r).normal(size=(
                     helpers.MAX_N_INSTANCES, 16)) for r in range(RANKS)]
                 ).astype(np.float32))}
    for kind, (cfg, batches, tables) in cases.items():
        runs = {dev: ranks_run(testing.ddp_steps, f"tiny {kind} DDP {dev}",
                               args=(cfg, batches, 2, None, tables),
                               device=dev) for dev in ("cuda", "cpu")}
        for dev, ranks in runs.items():
            for i, recs in enumerate(zip(*ranks)):
                check(len({r["digest"] for r in recs}) == 1,
                      f"tiny {kind} DDP on {dev} step {i}: the replicas "
                      "differ")
        for i, (card, cpu) in enumerate(zip(runs["cuda"][0],
                                            runs["cpu"][0])):
            for k, v in cpu["metrics"].items():
                got = card["metrics"][k]
                check(np.isfinite(got) and abs(got - v)
                      <= STEP_LOSS_RTOL * abs(v) + 1e-7,
                      f"tiny {kind} DDP step {i} {k}: card {got} vs CPU {v}")
            grads = {f"G.{n}": g for n, g in cpu["g_grads"].items()}
            grads.update({f"D.{n}": g for n, g in cpu["d_grads"].items()})
            got = {f"G.{n}": g for n, g in card["g_grads"].items()}
            got.update({f"D.{n}": g for n, g in card["d_grads"].items()})
            gmax = max(float(g.abs().max()) for n, g in grads.items()
                       if n.startswith("G."))
            worst, zero = 0.0, 0
            for name, want in grads.items():
                scale = float(want.abs().max())
                err = float((got[name] - want).abs().max())
                if name.startswith("G.") and scale < ZERO_GRAD * gmax:
                    zero += 1
                    check(float(got[name].abs().max()) < ZERO_GRAD * gmax,
                          f"tiny {kind} DDP step {i} {name} is not ~0 on "
                          "the card")
                    continue
                worst = max(worst, err / scale if scale > 0 else err)
                check(err <= STEP_GRAD_RTOL * scale,
                      f"tiny {kind} DDP step {i} gradient {name}: card vs "
                      f"CPU max|d| {err:.3e}, scale {scale:.3e}")
            log(f"tiny {kind} DDP step {i}, 2 ranks card vs CPU: GenLoss "
                f"{card['metrics']['GenLoss']:.6f} / "
                f"{cpu['metrics']['GenLoss']:.6f}; averaged gradients worst "
                f"max|d| / scale {worst:.3e} ({zero} tensors 0 in exact "
                "arithmetic); replicas bit-equal on both devices")
        if tables is not None:
            z = [r[0]["z_sums"] for r in runs["cuda"]]
            check(z[0] != z[1], f"tiny {kind} DDP: the ranks drew the same "
                  "z table")
            log(f"tiny {kind} DDP: the ranks' z tables differ (sums "
                f"{[round(v[0], 3) for v in z]})")


def ddp_full_rank(rank, world, device, kind, n_warm, n_timed):
    """Phase 28's rank: the full-width data-parallel step of ``kind``.
    REST: phase 9's batch on rank 0, another draw and crop on rank 1;
    BLDG: the rank-th largest building of the city (172, 168).  Rank 0
    holds its first step's K1, K2 and K3 (and G1, G1b on REST) against
    their plain versions; then warm-up and timed steps with the launch
    counts set to 0 just before them, a replica digest after every
    step."""
    import torch

    from gaussiancity_tpu_torch.ops import hash_grid, hash_grid_bwd
    from gaussiancity_tpu_torch.ops.rasterizer import blend
    from gaussiancity_tpu_torch.training.checkpoint import state_digest
    from gaussiancity_tpu_torch.training.step import (
        Trainer, make_parallel_train_step)

    rank_setup(device)
    if kind == "REST":
        trainer = Trainer(rest_train_config(), device=device, seed=0)
        batch = synthetic_rest_batch(trainer.cfg, TRAIN_POINTS, 1 + rank,
                                     device)
        if rank:
            batch["crp_xy"] = torch.tensor([[300, 64]], dtype=torch.int32,
                                           device=device)
    else:
        trainer = Trainer(bldg_train_config(), device=device, seed=1)
        projections, centers = synthetic_city(512, 48, seed=0)
        batch, _ = building_batch(trainer.cfg, projections, centers, device,
                                  rank=rank)
    step = make_parallel_train_step(trainer)
    digests, entries = [], {}
    if rank == 0 and kind == "REST":
        captured = capture_step_inputs(trainer, batch, step)
        entries = {"blend_fwd": k1_measure("DDP REST step",
                                           captured["blend_fwd"]),
                   "blend_bwd": k2_measure("DDP REST step",
                                           captured["blend_bwd"]),
                   **hash_grid_uses(captured, "DDP REST step")}
        entries["blend_fwd"].pop("touched_share")
        del captured
    elif rank == 0:
        entries = phase_bldg_kernels(trainer, batch, "DDP BLDG step", step)
        entries["blend_fwd"].pop("touched_share")
    else:
        step(batch)
    digests.append(state_digest(trainer))
    for _ in range(n_warm):
        step(batch)
        digests.append(state_digest(trainer))
    counters = {"blend_fwd": blend.blend_forward,
                "blend_bwd": blend.blend_backward,
                "segment_sum": hash_grid_bwd.segment_sum_sorted}
    if kind == "REST":
        counters.update(hash_encode_fwd=hash_grid.hash_encode_fwd,
                        hash_encode_bwd=hash_grid.hash_encode_bwd)
    for fn in counters.values():
        fn.launches = 0
    trainer.stage_ms.clear()
    trainer.time_stages = True
    torch.cuda.reset_peak_memory_stats(device)
    step_ms, per_step, metrics = [], [], []
    for _ in range(n_timed):
        counts = {n: fn.launches for n, fn in counters.items()}
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({n: fn.launches - counts[n]
                         for n, fn in counters.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        digests.append(state_digest(trainer))
    trainer.time_stages = False
    return {"step_ms": step_ms, "stage_ms": dict(trainer.stage_ms),
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "per_step": per_step, "metrics": metrics, "digests": digests,
            "entries": entries}


def phase_ddp_full(kernels, kind: str, n_warm: int = 2,
                   n_timed: int = 5) -> dict:
    """Phase 28: the full-width data-parallel step of ``kind`` on two
    ranks sharing the card over gloo: medians, stage split with the
    collectives as ``allreduce``, peaks; replicas bit-equal after every
    step, finite losses, counters 0, the kernels on every step of every
    rank; rank 0's first-step kernels held against their plain
    versions."""
    ranks = ranks_run(ddp_full_rank, f"full-width DDP {kind}",
                      args=(kind, n_warm, n_timed))
    for i, ds in enumerate(zip(*[r["digests"] for r in ranks])):
        check(len(set(ds)) == 1, f"DDP {kind} step {i}: the replicas differ")
    need = 2 if kind == "REST" else 1  # K3: both uses on REST
    for r, res in enumerate(ranks):
        for i, (m, launched) in enumerate(zip(res["metrics"],
                                              res["per_step"])):
            for k, v in m.items():
                check(np.isfinite(v), f"DDP {kind} rank {r} step {i}: {k}")
            check(m["RasterGradTruncated"] == 0
                  and m["PTv3PoolOverflow"] == 0,
                  f"DDP {kind} rank {r} step {i}: exactness counters {m}")
            check(min(launched.values()) >= 1
                  and launched["segment_sum"] >= need,
                  f"DDP {kind} rank {r} step {i}: a kernel was not "
                  f"launched ({launched})")
        med = float(np.median(res["step_ms"]))
        log(f"DDP {kind} rank {r}: median step {med:.2f} ms of "
            f"{len(res['step_ms'])} (stage timers synchronise the card), "
            f"peak {res['peak_gib']:.2f} GiB; GenLoss "
            f"{res['metrics'][-1]['GenLoss']:.5f} (averaged)")
        for stage, ms in res["stage_ms"].items():
            log(f"  rank {r} stage {stage:10s} " + " ".join(
                f"{v:9.2f}" for v in ms)
                + f"   median {float(np.median(ms)):9.2f} ms")
    log(f"DDP {kind}: replicas bit-equal after all "
        f"{len(ranks[0]['digests'])} steps; K1, K2, K3"
        + (", G1 and G1b" if kind == "REST" else "")
        + " on every timed step of both ranks")
    use = f"ddp_{kind.lower()}_step"
    totals = {n: sum(s[n] for r in ranks for s in r["per_step"])
              for n in ranks[0]["per_step"][0]}
    for name, e in ranks[0]["entries"].items():
        if name == "segment_sum" and kind == "REST":
            for kind_k3, u in e.items():
                add_use(kernels, name, f"{use}_{kind_k3}", u,
                        totals[name] // 2)
        else:
            add_use(kernels, name, use, e, totals[name])
    return {"median_ms": [float(np.median(r["step_ms"])) for r in ranks],
            "peak_gib": [r["peak_gib"] for r in ranks],
            "allreduce_ms": [float(np.median(r["stage_ms"]["allreduce"]))
                             for r in ranks]}


def first_pose_gaussians(pipe, projections, centers, poses):
    """The Gaussians, camera and config of the first pose's rasterize
    call of ``pipe`` (phase 6's REST frame)."""
    from gaussiancity_tpu_torch.inference import pipeline as pl

    calls = capture_calls([(pl, "rasterize_points14")],
                          lambda: pipe.render_trajectory(
                              projections, centers, poses[:1]))
    gs, cam, cfg = calls["rasterize_points14"][0]
    # copies outside inference mode, so that autograd may record them
    return gs.cpu().numpy(), cam._replace(
        view_matrix=cam.view_matrix.cpu().clone(),
        full_proj=cam.full_proj.cpu().clone(),
        cam_pos=cam.cam_pos.cpu().clone()), cfg


def sharded_raster_probe(rank, run, shape):
    """Phase 29's rasterizer probe around ``testing.sharded_raster_rank``:
    the band's K1 and K2 launches of one render and backward (captured);
    rank 0 holds them against their plain versions (K2 at ``shape``:
    tiles, capacity, band rows, width); then 4 timed runs.  Returns (the
    last run's output, the launches, entries and median ms)."""
    import torch

    from gaussiancity_tpu_torch.ops.rasterizer import blend

    blend.blend_forward.launches = blend.blend_backward.launches = 0
    captured = capture_calls([(blend, "blend_forward"),
                              (blend, "blend_backward")], run)
    entries = {}
    if rank == 0:
        entries = {"blend_fwd": k1_measure("sharded rasterizer band 0",
                                           captured["blend_forward"][0]),
                   "blend_bwd": k2_measure("sharded rasterizer band 0",
                                           captured["blend_backward"][0],
                                           shape)}
        entries["blend_fwd"].pop("touched_share")
    launches = {"blend_fwd": len(captured["blend_forward"]),
                "blend_bwd": len(captured["blend_backward"])}
    del captured
    ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, {"launches": launches, "entries": entries,
                 "ms": float(np.median(ms[1:]))}


def phase_sharded_raster(kernels, gs, cam, cfg, device="cuda") -> None:
    """Phase 29a: phase 6's first-pose Gaussians through the band-sharded
    rasterizer on two ranks against the single-device ``rasterize`` and
    its backward."""
    import functools

    import torch

    from gaussiancity_tpu_torch import testing
    from gaussiancity_tpu_torch.ops.rasterizer import (rasterize,
                                                       unpack_points14)
    from gaussiancity_tpu_torch.parallel.sharded_raster import band_height

    # the reference's backward with no slot budget, as the bands' (the
    # recipe's 65,536 slots would truncate the whole frame's backward)
    cfg = cfg.replace(grad_budget=0)
    n = -(-gs.shape[0] // RANKS) * RANKS
    valid = np.arange(n) < gs.shape[0]
    gs = np.concatenate([gs, np.repeat(gs[:1], n - gs.shape[0], 0)])
    band = band_height(cam.img_h, cfg.tile_h, RANKS)
    log(f"sharded rasterizer: {gs.shape[0]} Gaussians at {cam.img_w}x"
        f"{cam.img_h}, {RANKS} bands of {band} rows "
        f"({band * RANKS - cam.img_h} cropped)")
    shape = (band // cfg.tile_h * -(-cam.img_w // cfg.tile_w),
             cfg.tile_capacity, band, cam.img_w)
    scene = [a.numpy() for a in unpack_points14(torch.from_numpy(gs))]
    ranks = ranks_run(testing.sharded_raster_rank, "sharded rasterizer",
                      args=(scene, valid, np.zeros(3, np.float32), cam, cfg,
                            functools.partial(sharded_raster_probe,
                                              shape=shape)))
    dev = torch.device(device)
    x = torch.as_tensor(gs, device=dev).requires_grad_(True)
    camd = cam._replace(view_matrix=cam.view_matrix.to(dev),
                        full_proj=cam.full_proj.to(dev),
                        cam_pos=cam.cam_pos.to(dev))
    out = rasterize(*unpack_points14(x), camd, cfg,
                    valid=torch.as_tensor(valid, device=dev),
                    bg=torch.zeros(3, device=dev))
    check(int(out.n_grad_truncated) == 0 and int(out.n_truncated) == 0,
          "the single-device reference render truncated")
    counts = [r["counts"] for r in ranks]
    log(f"sharded rasterizer: the bands' counters (dropped pairs, "
        f"truncated, gradient-truncated) {counts[0]}")
    check(counts == [[int(out.n_dropped_pairs), 0, 0]] * RANKS,
          f"the bands' counters {counts} differ from the reference's")
    ref = out.image
    (ref ** 2).sum().backward()
    ref, gref = ref.detach().cpu(), x.grad.cpu()
    img = ranks[0]["image"]
    check(all(torch.equal(img, r["image"]) for r in ranks),
          "the ranks' sharded images differ")
    err = float((img - ref).abs().max())
    log(f"sharded rasterizer vs single-device rasterize: image max|d| "
        f"{err:.3e}, bit-equal {torch.equal(img, ref)}")
    check(tuple(img.shape) == tuple(ref.shape) and err <= 1e-5,
          f"sharded image differs from rasterize by {err:.3e}")
    grad = torch.cat([torch.cat([g.reshape(len(g), -1) for g in r["grads"]],
                                1) for r in ranks])
    scale = gref.abs().amax(dim=0).clamp(min=1e-30)
    rel = float(((grad - gref).abs() / scale).max())
    log(f"sharded rasterizer gradients (sum of squares): worst max|d| / "
        f"column scale {rel:.3e} over 14 columns")
    check(rel <= 1e-4, "sharded rasterizer gradients differ from the "
          f"single-device backward by {rel:.3e} of a column's scale")
    for r, res in enumerate(ranks):
        check(min(res["launches"].values()) >= 1,
              f"rank {r}'s band did not launch K1 and K2: {res['launches']}")
    log(f"sharded rasterizer: render + backward median "
        f"{[round(r['ms'], 2) for r in ranks]} ms per rank; K1 / K2 "
        f"launches per band {[r['launches'] for r in ranks]}")
    for name, e in ranks[0]["entries"].items():
        add_use(kernels, name, "sharded_raster", e,
                sum(r["launches"][name] for r in ranks))


def frame_inputs(pipe, projections, centers, poses, lut) -> dict:
    """Per pose of ``pipe``'s trajectory: the buckets its generators take
    (each with its count of real rows), its camera (on the host: the one
    ``raster_view`` builds on the card) and the road mask (an untimed pass
    of phase 11's trajectory), with the projection maps and the style
    table."""
    got, pending = {"frames": []}, {}
    pred, view, blur, prep = (pipe.predict_attrs_single, pipe.raster_view,
                              pipe.road_blur, pipe.prepare)

    def predict(name, pts9, *args, **kwargs):
        pending[name] = (pts9.cpu().numpy(), len(pts9))
        return pred(name, pts9, *args, **kwargs)

    def raster_view(gs, pos, quat):
        cam = pipe.camera.params_f32(pos, quat)
        got["frames"].append({"buckets": dict(pending), "cam": cam._replace(
            view_matrix=cam.view_matrix.cpu(), full_proj=cam.full_proj.cpu(),
            cam_pos=cam.cam_pos.cpu())})
        pending.clear()
        return view(gs, pos, quat)

    def road_blur(img, road):
        got["frames"][-1]["road"] = road.cpu()
        return blur(img, road)

    def prepare(*args, **kwargs):
        out = prep(*args, **kwargs)
        got["maps"] = tuple(t.cpu() for t in out[1:])
        return out

    pipe.predict_attrs_single, pipe.raster_view = predict, raster_view
    pipe.road_blur, pipe.prepare = road_blur, prepare
    try:
        pipe.render_trajectory(projections, centers, poses, style_lut=lut)
    finally:
        for name in ("predict_attrs_single", "raster_view", "road_blur",
                     "prepare"):
            delattr(pipe, name)
    return got


def sharded_frame_probe(rank, i, run, fr, pipe, n):
    """Phase 29's frame probe around ``testing.sharded_frame_rank``, whose
    frames are phase 11's ``n`` poses twice: frame i's image through the
    frame's flips, road blur and uint8 cast.  The first pass warms up; the
    second is timed, with the launch counts set to 0 just before it.  On
    the first frame, rank 0 holds its K1 and G1 against their plain
    versions (every rank captures: the frame's collectives are shared)."""
    import torch

    from gaussiancity_tpu_torch.inference.pipeline import frame_to_uint8
    from gaussiancity_tpu_torch.ops import hash_grid
    from gaussiancity_tpu_torch.ops.rasterizer import blend

    def finished():
        out = run()
        img = out.image.flip(-1)
        if pipe.ds.flip_ud:
            img = img.flip(-2)
        return out, pipe.road_blur(img.permute(1, 2, 0),
                                   fr["road"].to(img.device))

    rec = {}
    if i == n:  # the timed pass starts
        blend.blend_forward.launches = 0
        hash_grid.hash_encode_fwd.launches = 0
    if i == 0:
        captured = capture_calls(
            [(blend, "blend_forward"), (hash_grid, "hash_encode_fwd")],
            finished)
        if rank == 0:
            rec["entries"] = {"blend_fwd": k1_measure(
                "sharded frame band 0", captured["blend_forward"][0]),
                "hash_encode_fwd": g1_use(phase_g1(
                    "sharded frame, rank 0's REST rows",
                    captured["hash_encode_fwd"][0]))}
            rec["entries"]["blend_fwd"].pop("touched_share")
        del captured
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, img = finished()
    torch.cuda.synchronize()
    if i >= n:
        rec.update(ms=(time.perf_counter() - t0) * 1e3,
                   frame=frame_to_uint8(img),
                   counts=[int(c) for c in out[1:]])
    if i == 2 * n - 1:
        rec["launches"] = {"blend_fwd": blend.blend_forward.launches,
                           "hash_encode_fwd":
                               hash_grid.hash_encode_fwd.launches}
    return rec


def phase_sharded_frame(kernels, cfg, inputs, frames_f32,
                        stage_medians: dict) -> None:
    """Phase 29b: phase 11's two-model frames through
    ``make_sharded_frame`` on two ranks: within 1 grey level of phase
    11's frames at >= 99 % of pixels; its median beside phase 11's
    generator + rasterize + blur stages."""
    import functools

    from gaussiancity_tpu_torch import testing

    n = len(inputs["frames"])
    log("sharded frame buckets (REST, BLDG) per pose: "
        + str([tuple(c for _, c in f["buckets"].values())
               for f in inputs["frames"]]))
    runs = ranks_run(testing.sharded_frame_rank, "sharded two-model frame",
                     args=(cfg, two_model_pipeline, inputs["frames"] * 2,
                           inputs["maps"], functools.partial(
                               sharded_frame_probe, n=n)))
    ranks = [{"frames": [f["frame"] for f in recs[n:]],
              "ms": [f["ms"] for f in recs[n:]],
              "counts": [f["counts"] for f in recs[n:]],
              "entries": recs[0].get("entries", {}),
              "launches": recs[-1]["launches"]} for recs in runs]
    for r, res in enumerate(ranks):
        check(len(res["frames"]) == n, f"rank {r} rendered "
              f"{len(res['frames'])} frames")
        check(res["launches"]["blend_fwd"] >= n
              and res["launches"]["hash_encode_fwd"] >= n,
              f"rank {r}: K1 or G1 missing from a frame {res['launches']}")
        check(res["counts"] == ranks[0]["counts"]
              and all(c[2] == 0 for c in res["counts"]),
              f"rank {r}: the bands' counters {res['counts']}")
    log("sharded frame: the bands' counters (dropped pairs, truncated, "
        f"gradient-truncated) per frame {ranks[0]['counts']}")
    for i, (f0, ref) in enumerate(zip(ranks[0]["frames"], frames_f32)):
        check(all(np.array_equal(f0, r["frames"][i]) for r in ranks),
              f"sharded frame {i}: ranks differ")
        d = np.abs(f0.astype(np.int16) - ref.astype(np.int16))
        share = float((d <= 1).mean())
        log(f"sharded frame {i}: within 1 grey level of phase 11's at "
            f"{share:.6f} of pixels (max {int(d.max())}), equal at "
            f"{float((d == 0).mean()):.6f}")
        check(share >= 0.99, f"sharded frame {i} differs from phase 11's")
    ref_ms = sum(stage_medians.get(k, 0.0) for k in
                 ("generator", "rasterize", "blur"))
    log(f"sharded frame (generators + rasterizer + flips and blur, buckets "
        f"given): median per rank "
        f"{[round(float(np.median(r['ms'])), 2) for r in ranks]} ms; phase "
        f"11's generator + rasterize + blur stage medians {ref_ms:.2f} ms "
        "(this call)")
    for name, e in ranks[0]["entries"].items():
        add_use(kernels, name, "sharded_frame", e,
                sum(r["launches"][name] for r in ranks))


def phase_cli_ddp(root: str) -> None:
    """Phase 30: the CLI on two processes on the card (gloo: they share
    it), 4 steps of the tiny REST widths on phase 16's city: one
    checkpoint, written by rank 0; both ranks' replica digests equal to
    the checkpoint's; counters 0; then ``--test`` on it."""
    import re
    import socket

    import torch

    from gaussiancity_tpu_torch.training import checkpoint
    from gaussiancity_tpu_torch.training.step import Trainer

    out_dir = os.path.join(cli_root(), "out_ddp")
    cfg = cli_config(root, out_dir).replace(exp_name="chip_smoke_ddp")
    cfg_path = os.path.join(cli_root(), "tiny_rest_ddp.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    common = ["-r", "rest", "-d", "GOOGLE_EARTH", "-c", cfg_path]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gaussiancity_tpu_torch", *common, "-e",
         cfg.exp_name, "--max-steps", "4", "--device", "cuda",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes",
         str(RANKS), "--process-id", str(r)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=CLI_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            log(f"CLI rank {r} failed; the end of its output:\n"
                f"{text[-4000:]}")
        check(p.returncode == 0, f"CLI rank {r} exited {p.returncode}")
        check("backend gloo" in text and "device: cuda:0" in text,
              f"CLI rank {r} did not run gloo on the card")
    digests = [re.search(r"replica digest (\w+)", t).group(1) for t in texts]
    ckpt_dir = os.path.join(out_dir, "ckpt", cfg.exp_name)
    check(sorted(os.listdir(ckpt_dir)) == ["epoch-00001.pt"],
          f"the two-process CLI wrote {os.listdir(ckpt_dir)}")
    trainer = Trainer(cfg, device="cuda", seed=cfg.train.seed)
    checkpoint.restore_checkpoint(ckpt_dir, trainer)
    want = checkpoint.state_digest(trainer)
    check(trainer.step == 4 and digests == [want] * RANKS,
          "the two-process CLI's ranks do not hold the checkpoint's state")
    del trainer
    torch.cuda.empty_cache()
    with open(os.path.join(out_dir, "logs", cfg.exp_name,
                           "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    counters = {k: max(r[k] for r in rows if k in r) for k in (
        "Raster/Batch/RasterDroppedPairs", "Raster/Batch/RasterTruncated",
        "Raster/Batch/RasterGradTruncated", "Raster/Batch/PTv3PoolOverflow")}
    check(not any(counters.values()),
          f"the two-process CLI overflowed: {counters}")
    epoch_s = float(re.search(r"\[Epoch 1/1\] done in ([0-9.]+)s",
                              texts[0]).group(1))
    text, _ = run_cli(common + ["--test", "-p", ckpt_dir],
                      "the CLI's --test mode on the two-process checkpoint",
                      "cuda")
    val = float(re.search(r"\[Val\]\[Epoch 1\] L1Loss (\S+)", text).group(1))
    check(np.isfinite(val), "--test on the two-process checkpoint")
    log(f"CLI on {RANKS} processes (gloo, one card): 4 steps a rank, epoch "
        f"{epoch_s:.2f} s, processes {wall:.2f} s; one checkpoint by rank "
        f"0; replicas bit-equal to it (digest {want[:16]}); counters "
        f"{counters}; --test val L1 {val:.5f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    profiling = "--profile" in sys.argv[1:]
    # a run that hangs prints where, and fails inside its time limit
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    t_start = time.perf_counter()
    shutil.rmtree(cli_root(), ignore_errors=True)
    try:
        return run_phases(profiling, t_start)
    finally:
        shutil.rmtree(cli_root(), ignore_errors=True)


def run_phases(profiling: bool, t_start: float) -> int:
    import torch

    from gaussiancity_tpu_torch.config import rest_recipe
    from gaussiancity_tpu_torch.inference.pipeline import (
        get_orbit_camera_poses, get_style_lut)
    from gaussiancity_tpu_torch.training import checkpoint

    phase_build()
    card = phase_card()
    device = torch.device("cuda")
    cfg = rest_recipe()
    cfg = cfg.replace(
        dataset=cfg.dataset.replace(proj_size=512, map_size=512),
        rasterizer=cfg.rasterizer.replace(tile_capacity=2048))
    kernels = [phase_blend(cfg, device)]
    projections, centers = synthetic_city(512, 48, seed=0)
    poses = get_orbit_camera_poses(512, n_points=4, radius=220,
                                   altitude=260)
    pipe = city_pipeline(cfg, device)
    kernels.append(phase_raycast(pipe, projections, poses))
    phase_small_reference()
    launches, g1_args, _ = phase_frame(pipe, projections, centers, poses,
                                       what="REST frame")
    timed = [launches]
    if profiling:
        phase_profile(pipe, projections, centers, poses)
    g1 = {"rest_frame": phase_g1("REST frame", g1_args)}
    first_gs = first_pose_gaussians(pipe, projections, centers, poses)
    del pipe, g1_args
    torch.cuda.empty_cache()

    phase_small_two_model()
    lut = get_style_lut(centers, 256, seed=0)
    pipe = two_model_pipeline(cfg, device)
    launches, g1_frame_args, frames_f32 = phase_two_model_frame(
        pipe, projections, centers, poses, lut)
    timed.append(launches)
    frame_medians = {stage: float(np.median(ms))
                     for stage, ms in pipe.stage_ms.items()
                     if len(ms) == len(poses)}
    sharded_in = frame_inputs(pipe, projections, centers, poses, lut)
    if profiling:
        phase_profile(pipe, projections, centers, poses, lut)
    g1["two_model_frame_rest_bucket"] = phase_g1(
        "two-model frame, REST bucket", g1_frame_args)
    del pipe, g1_frame_args
    torch.cuda.empty_cache()

    from gaussiancity_tpu_torch.training.step import Trainer

    log("the perceptual loss runs on seeded RANDOM VGG19 weights: the "
        "repository holds no converted ImageNet weights")
    trainer = Trainer(rest_train_config(), device=device, seed=0)
    batch = rest_batch = synthetic_rest_batch(trainer.cfg, TRAIN_POINTS,
                                              seed=1, device=device)
    captured = capture_step_inputs(trainer, batch)
    kernels += phase_grad_kernels(captured)
    g1["train_step"] = phase_g1("train step", captured["hash_encode_fwd"][0])
    kernels.append(g1_entry(g1))
    g1b_args = captured["hash_encode_bwd"][0]
    g1b = phase_g1b(g1b_args)
    g1b["backward_launches_per_step"] = phase_bwd_launches(g1b_args)
    kernels.append(g1b)
    del captured, g1b_args
    phase_small_train(device)
    rest_step = phase_train(trainer, batch)
    timed.append(rest_step)
    g1b["backward_ab"] = phase_train_backward_ab(trainer, batch)
    if profiling:
        phase_train_profile(trainer, batch)
    ckpt_dirs = {name: os.path.join(cli_root(), f"ckpt_{name.lower()}")
                 for name in ("REST", "BLDG")}
    checkpoint.save_epoch(ckpt_dirs["REST"], 1, trainer)
    del trainer
    torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    phase_small_bldg_train(device)
    log(f"phase time: tiny BLDG steps card vs CPU "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    trainer = Trainer(bldg_train_config(), device=device, seed=1)
    batch, eval_batch = building_batch(trainer.cfg, projections, centers,
                                       device)
    bldg_uses = phase_bldg_kernels(trainer, batch)
    bldg_step = phase_bldg_train(trainer, batch, eval_batch)
    timed.append(bldg_step)
    for k in kernels:
        if k["name"] in bldg_uses:
            use = dict(bldg_uses[k["name"]])
            use["launches"] = bldg_step["segment_sum_by_use"]["bldg_step"] \
                if k["name"] == "segment_sum" else bldg_step[k["name"]]
            k.setdefault("uses", {})["bldg_step"] = use
    if profiling:
        phase_train_profile(trainer, batch)
    checkpoint.save_epoch(ckpt_dirs["BLDG"], 1, trainer)
    del trainer, batch, eval_batch
    torch.cuda.empty_cache()
    log(f"phase time: full-width BLDG train step "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_train_loop(device)
    log(f"phase time: training loop {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    city, v1_use, e1_view = phase_dataset_generation(projections, device)
    next(k for k in kernels if k["name"] == "raycast").setdefault(
        "uses", {})["dataset_view"] = v1_use
    e1 = {"name": "extrude", "route": "cuda",
          "source": "gaussiancity_tpu_torch/csrc/extrude.cu",
          "replaces": "gaussiancity_tpu/ops/extrusion.py:83",
          **{k: e1_view[k] for k in (
              "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms")},
          "uses": {"dataset_view": e1_view}}
    kernels.append(e1)
    log(f"phase time: dataset generation {time.perf_counter() - t_phase:.1f}"
        " s")
    t_phase = time.perf_counter()
    phase_cli_train(os.path.dirname(city), "cuda")
    log(f"phase time: CLI train and --test {time.perf_counter() - t_phase:.1f}"
        " s")
    t_phase = time.perf_counter()
    cli_uses = phase_cli_inference(city, ckpt_dirs, "cuda")
    for k in kernels:
        if k["name"] in cli_uses:
            k.setdefault("uses", {})["cli_frame"] = cli_uses[k["name"]]
    log(f"phase time: CLI --inference {time.perf_counter() - t_phase:.1f} s")
    kernels.append(phase_k4(device))
    t_phase = time.perf_counter()
    phase_small_surface(device, projections)
    log(f"phase time: small model-surface checks card vs CPU "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    rest_bf16 = phase_rest_bf16(kernels, rest_batch, profiling)
    timed.append(rest_bf16)
    log(f"REST step median: bf16 {rest_bf16['median_ms']:.2f} ms, peak "
        f"{rest_bf16['peak_gib']:.2f} GiB; float32 (phase 9, this call) "
        f"{rest_step['median_ms']:.2f} ms, peak "
        f"{rest_step['peak_gib']:.2f} GiB")
    log(f"phase time: bf16 REST step {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    b2 = phase_bldg_b2(kernels, projections, centers, profiling)
    timed += list(b2.values())
    log("BLDG step medians: B=1 float32 (phase 14) "
        f"{bldg_step['median_ms']:.2f} ms, peak {bldg_step['peak_gib']:.2f} "
        "GiB; " + "; ".join(
            f"B=2 {k} {v['median_ms']:.2f} ms (PTv3 {v['ptv3_ms']:.2f}, "
            f"backward {v['backward_ms']:.2f}), peak {v['peak_gib']:.2f} GiB"
            for k, v in b2.items()))
    log(f"phase time: BLDG steps at B=2 {time.perf_counter() - t_phase:.1f}"
        " s")
    t_phase = time.perf_counter()
    local = phase_local_step(kernels, rest_batch, projections, profiling)
    timed.append(local)
    log(f"LOCAL REST step median {local['median_ms']:.2f} ms, peak "
        f"{local['peak_gib']:.2f} GiB")
    log(f"phase time: LOCAL REST step {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_ptv3_options(projections, centers)
    log(f"phase time: PTv3 options {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    timed.append(phase_bf16_frame(kernels, cfg, projections, centers,
                                  poses, lut, frames_f32,
                                  timed[1]["median_ms"]))
    log(f"phase time: bf16 two-model frame "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_nccl_world1()
    log(f"phase time: NCCL world 1 {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_small_ddp()
    log(f"phase time: tiny DDP steps, 2 ranks card vs CPU "
        f"{time.perf_counter() - t_phase:.1f} s")
    for kind in ("REST", "BLDG"):
        t_phase = time.perf_counter()
        ddp = phase_ddp_full(kernels, kind)
        single = rest_step if kind == "REST" else bldg_step
        log(f"DDP {kind} step medians per rank {ddp['median_ms']} ms "
            f"(allreduce stage {ddp['allreduce_ms']} ms), peaks "
            f"{ddp['peak_gib']} GiB; one device (phase "
            f"{9 if kind == 'REST' else 14}, this call) "
            f"{single['median_ms']:.2f} ms, {single['peak_gib']:.2f} GiB")
        log(f"phase time: full-width DDP {kind} "
            f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_sharded_raster(kernels, *first_gs)
    phase_sharded_frame(kernels, cfg, sharded_in, frames_f32, frame_medians)
    del first_gs, sharded_in
    log(f"phase time: sharded rasterizer and frame "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_cli_ddp(os.path.dirname(city))
    log(f"phase time: CLI on 2 processes {time.perf_counter() - t_phase:.1f}"
        " s")
    t_phase = time.perf_counter()
    phase_raw_capture(e1, "cuda")
    log(f"phase time: raw capture to training city "
        f"{time.perf_counter() - t_phase:.1f} s")
    # launches on the timed passes: REST frame, two-model frame, REST
    # train steps, BLDG train steps; K4's are those of its probe's timed
    # drive; per use, K3's from the REST train steps, G1's from the pass
    # of its use, and the "bldg_step" uses' from the BLDG train steps
    g1_pass = {"rest_frame": 0, "two_model_frame_rest_bucket": 1,
               "train_step": 2}
    for k in kernels:
        if "launches" not in k:
            k["launches"] = sum(t.get(k["name"], 0) for t in timed)
        for use, entry in k.get("uses", {}).items():
            if "launches" in entry:
                continue
            if k["name"] == "segment_sum":
                entry["launches"] = rest_step["segment_sum_by_use"][use]
            else:
                entry["launches"] = timed[g1_pass[use]][k["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
