#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``gaussiancity_tpu_torch``) on one
NVIDIA card.

Phases, each of which fails the run if it fails:

1. build every hand-written kernel of ``gaussiancity_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all started together);
2. print the card's name and power limit, and turn TF32 off;
3. hold the blend forward (K1) against its plain PyTorch version at the
   frame's shape (960x540 at 32x32 tiles: 510 tiles, 2048 slots, the
   16x16 reference gate on), on a seeded scene;
4. hold the first-hit raycast (V1) against its plain version on the
   synthetic city's 512x512x192 id volume at 960x540;
5. render a small trajectory on the card and on the CPU (plain versions)
   and compare the frames;
6. render a REST inference trajectory at the REST recipe's full widths
   through ``InferencePipeline.render_trajectory`` (warm-up pass, then a
   timed pass with the kernels' launch counts set to 0 just before it),
   and check that every frame has content and went through K1 and V1.

It prints timings beside the card's name and power limit, a ``kernels``
JSON line (launches on the timed pass, time, plain time, bound, max
error), and as its last line ``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py``
(``--profile`` adds a torch.profiler pass over the frame path).  Without a
CUDA device, or outside the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor)
# FLOP/s, used for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# fp32 operations per evaluated (pixel, slot) pair in the blend: offsets
# (2), power (9), exp (1), alpha and clamp (2), the three eligibility tests
# (3), transmittance (2), weight (1), colour (6)
BLEND_FLOP_PER_EVAL = 26
# operations per DDA step: axis choice (2), cell step and exit test (3),
# next crossing (3), in-volume test (6), voxel address (4), hit test (1)
RAYCAST_OPS_PER_STEP = 19

K1_TOL = 1e-5  # image and final_T, max abs
MATCH_SHARE = 0.999  # n_contrib and voxel ids: share of pixels equal
N_BLEND_GAUSSIANS = 400_000  # Gaussians of K1's seeded test scene


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card over ``iters`` runs (CUDA events,
    after ``warmup`` runs)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    T, K = idx.shape
    bg = torch.tensor([0.1, 0.2, 0.3], device=device)
    args = (attrs, idx, counts, (0.0, 0.0), bg, H, W, consts)
    log(f"K1 inputs: T={T} K={K} N={attrs.shape[0]} slots={int(counts.sum())}"
        f" max count={int(counts.max())} truncated={int(bins.n_truncated)}")
    check(T == 510 and K == 2048, "K1 must run at the frame shape")
    got = blend.blend_forward(*args)
    want = blend.blend_forward_plain(*args)
    torch.cuda.synchronize()
    err_img = float((got[0] - want[0]).abs().max())
    err_T = float((got[1] - want[1]).abs().max())
    share = float((got[2] == want[2]).float().mean())
    log(f"K1 vs plain: image max|d|={err_img:.3e} final_T max|d|={err_T:.3e}"
        f" n_contrib equal {share:.6f}")
    check(err_img <= K1_TOL and err_T <= K1_TOL,
          f"K1 image/final_T differ from the plain version by more than "
          f"{K1_TOL}")
    check(share >= MATCH_SHARE, "K1 n_contrib differs from the plain version")
    check(float(want[0].std()) > 0.01, "K1 test scene renders nothing")
    ms = cuda_time_ms(lambda: blend.blend_forward(*args))
    plain_ms = cuda_time_ms(lambda: blend.blend_forward_plain(*args),
                            iters=2, warmup=1)
    # bound: bytes each input read once / each output written once, and
    # the evaluated (pixel, slot) pairs of this scene at the fp32 peak
    n_slots = int(counts.sum())
    n_gauss = int(torch.unique(idx[bins.kmask]).numel())
    n_bytes = (n_gauss * attrs.shape[1] * 4 + n_slots * 4 + T * 4
               + H * W * (3 + 1 + 1) * 4)
    n_eval = int(want[3].sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_eval * BLEND_FLOP_PER_EVAL / FP32_FLOP_PER_S * 1e3
    log(f"K1: {ms:.4f} ms, plain {plain_ms:.2f} ms; bound: {n_bytes} B -> "
        f"{t_bytes:.5f} ms, {n_eval} evaluated pairs -> {t_ops:.5f} ms")
    return {"name": "blend_fwd", "route": "cuda",
            "source": "gaussiancity_tpu_torch/csrc/blend_fwd.cu",
            "replaces": "gaussiancity_tpu/ops/rasterizer/blend_pallas.py:239",
            "max_abs_err": max(err_img, err_T), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


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
    vol = pipe._vol
    W, H = pipe.ds.sensor_size
    K = np.asarray(pipe.ds.cam_k).reshape(3, 3)
    pose = poses[1]
    dev = vol.device
    f32 = dict(dtype=torch.float32, device=dev)
    rays = vis.world_ray_basis(
        torch.tensor([pose[k] for k in ("tx", "ty", "tz")], **f32),
        torch.tensor([pose[k] for k in ("qx", "qy", "qz", "qw")], **f32),
        pipe._offsets)
    args = (vol, rays, float(K[0, 0]), (float(K[1, 2]), float(K[0, 2])),
            (H, W), pipe._ztop)
    log(f"V1 inputs: volume {tuple(vol.shape)} "
        f"({int((vol != 0).sum())} occupied) rays {H}x{W} "
        f"ztop={pipe._ztop}")
    got = vis.raycast(*args)
    want = vis.raycast_plain(*args)
    torch.cuda.synchronize()
    share = float((got[0] == want[0]).float().mean())
    both = (got[0] == want[0]) & (want[0] != 0)
    err = float((got[1][both] - want[1][both]).abs().max())
    hits = float((want[0] != 0).float().mean())
    log(f"V1 vs plain: voxel ids equal {share:.6f}, depth max|d| on equal "
        f"hits {err:.3e}, hit share {hits:.4f}")
    check(share >= MATCH_SHARE, "V1 voxel ids differ from the plain version")
    check(hits > 0.5, "V1 test view sees too little of the city")
    ms = cuda_time_ms(lambda: vis.raycast(*args))
    plain_ms = cuda_time_ms(lambda: vis.raycast_plain(*args), iters=2,
                            warmup=1)
    n_steps, n_cells = int(want[2].sum()), int(want[3])
    n_bytes = n_cells * 4 + 12 * 4 + H * W * 8
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_steps * RAYCAST_OPS_PER_STEP / FP32_FLOP_PER_S * 1e3
    log(f"V1: {ms:.4f} ms, plain {plain_ms:.2f} ms; bound: {n_bytes} B "
        f"({n_cells} cells read) -> {t_bytes:.5f} ms, {n_steps} DDA steps "
        f"-> {t_ops:.5f} ms")
    return {"name": "raycast", "route": "cuda",
            "source": "gaussiancity_tpu_torch/csrc/raycast.cu",
            "replaces": "gaussiancity_tpu/ops/visibility.py:154 "
                        "(ray_voxel_intersection, an XLA while_loop; no "
                        "Pallas kernel)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def phase_small_reference():
    """A small trajectory on the card (kernels) and on the CPU (plain
    versions) with the same seeded weights: the frames must agree."""
    import torch

    from gaussiancity_tpu_torch.config import (
        Config, DatasetConfig, GaussianNetworkConfig, PTv3Config,
        RasterizerConfig)
    from gaussiancity_tpu_torch.inference.pipeline import (
        InferencePipeline, get_orbit_camera_poses)
    from gaussiancity_tpu_torch.models.generator import Generator

    cfg = Config(
        dataset=DatasetConfig(sensor_size=(128, 64), proj_size=64,
                              cam_k=(60.0, 0, 64.0, 0, 60.0, 32.0, 0, 0, 1)),
        network=GaussianNetworkConfig(
            scale_factor=0.5, global_encoder_n_blocks=2,
            hash_grid_n_levels=2, hash_grid_level_dim=2,
            hash_grid_map_size=8, mlp_hidden_dim=16,
            ptv3=PTv3Config(enabled=False)),
        rasterizer=RasterizerConfig(tile_capacity=128))
    ins = np.ones((64, 64), np.int16)
    ins[10:20, 10:20] = 100
    ins[30:42, 30:44] = 102
    td = np.where(ins >= 100, 18, 2).astype(np.int16)
    projections = {"REST": {
        "INS": ins, "SEG": np.where(ins >= 100, 2, ins).astype(np.int16),
        "TD_HF": td, "BU_HF": np.zeros((64, 64), np.int16),
        "PTS": np.ones((64, 64), bool)}}
    centers = {i: (32.0, 32.0, 64.0, 64.0, 20.0) for i in range(200)}
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


def phase_frame(pipe, projections, centers, poses):
    import torch

    from gaussiancity_tpu_torch.ops import visibility as vis
    from gaussiancity_tpu_torch.ops.rasterizer import blend

    t0 = time.perf_counter()
    warm = pipe.render_trajectory(projections, centers, poses)
    log(f"frame path warm-up: {len(warm)} frames in "
        f"{time.perf_counter() - t0:.2f} s")
    pipe.stage_ms.clear()
    pipe.frame_stats.clear()
    pipe._pts_fp = None  # rebuild the volume: the timed pass is complete
    torch.cuda.reset_peak_memory_stats()
    blend.blend_forward.launches = 0
    vis.raycast.launches = 0
    t0 = time.perf_counter()
    frames = pipe.render_trajectory(projections, centers, poses)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"blend_fwd": blend.blend_forward.launches,
                "raycast": vis.raycast.launches}
    n = len(poses)
    log(f"frame path: {n} frames of {frames[0].shape} in {wall:.3f} s -> "
        f"{wall / n * 1e3:.2f} ms/frame (set-up included); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for stage, ms in pipe.stage_ms.items():
        log(f"  stage {stage:10s} " + " ".join(f"{m:9.2f}" for m in ms)
            + f"   mean {sum(ms) / len(ms):9.2f} ms")
    # per-frame stages (one entry per frame): extrude and volume are
    # per-trajectory set-up
    per_frame = [ms for ms in pipe.stage_ms.values() if len(ms) == n]
    frame_ms = [sum(col) for col in zip(*per_frame)]
    log("frame ms without set-up: " + " ".join(f"{m:.2f}" for m in frame_ms)
        + f"   mean {sum(frame_ms) / n:.2f} ms")
    for i, (f, st) in enumerate(zip(frames, pipe.frame_stats)):
        log(f"  frame {i}: std {float(f.std()):.2f} {st}")
        check(f.shape == (540, 960, 3) and f.dtype == np.uint8,
              "frame has the wrong shape")
        check(float(f.std()) > 1, f"frame {i} has no content")
    log(f"launches on the timed pass: {launches}")
    for name, count in launches.items():
        check(count >= n, f"kernel {name} was not launched on every frame")
    return launches


def phase_profile(pipe, projections, centers, poses):
    """One more pass under torch.profiler: device time by kernel and the
    device's busy share of the per-frame wall time (``--profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gaussiancity_tpu_torch.inference.pipeline import frame_to_uint8

    # per-trajectory set-up outside the window: only the frames are traced
    state = pipe.prepare(projections, centers)
    with torch.inference_mode():
        frame_to_uint8(pipe.render_pose(state[0], centers, *state[1:],
                                        poses[0])[0])
    torch.cuda.synchronize()
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pose in poses:
            frame_to_uint8(pipe.render_pose(state[0], centers, *state[1:],
                                            pose)[0])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # the kernels themselves: their events lie on the device
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and device_us(e) > 0]
    events.sort(key=lambda e: -device_us(e))
    busy_ms = sum(device_us(e) for e in events) / 1e3
    log(f"profile: {len(poses)} frames, wall "
        f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({busy_ms / wall_ms:.4f} of wall)")
    for e in events[:25]:
        log(f"  {device_us(e) / 1e3:10.3f} ms {e.count:6d}x "
            f"{e.key[:100]}")
    check(busy_ms > 0, "the profiler saw no device time")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from gaussiancity_tpu_torch.config import rest_recipe
    from gaussiancity_tpu_torch.inference.pipeline import (
        get_orbit_camera_poses)

    t_start = time.perf_counter()
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
    launches = phase_frame(pipe, projections, centers, poses)
    if "--profile" in sys.argv[1:]:
        phase_profile(pipe, projections, centers, poses)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
