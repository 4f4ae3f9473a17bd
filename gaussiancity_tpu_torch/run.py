# -*- coding: utf-8 -*-
"""The command line of the port (counterpart of the repository's
``run.py``; upstream run.py and scripts/inference.py): train a recipe,
validate a checkpoint, or render a city video from checkpoints.

    python3 -m gaussiancity_tpu_torch -e MyExp -r rest -d GOOGLE_EARTH
    python3 -m gaussiancity_tpu_torch --test -p output/ckpt/MyExp -r rest
    python3 -m gaussiancity_tpu_torch --inference --ckpt-rest DIR \\
        --ckpt-bldg DIR --city-dir CITY --output output/video.mp4

It takes the flags of the JAX ``run.py`` and ``--device`` (default
``cuda``; without a card it raises unless given ``--device cpu``).
Recipes are the constructors of ``config``; ``-c`` replaces the recipe
with a JSON config.  ``-p`` and ``--ckpt-*`` take the port's own
checkpoint directories (``training/checkpoint.py``) or the JAX package's
Orbax checkpoint directories (``training/orbax_reader.py``): render a
JAX-trained model, validate it, or resume its training with its Adam
state; a resumed run writes the port's own files.

Data-parallel training runs one process a rank, each started with the
same flags and its own ``--process-id``:

    python3 -m gaussiancity_tpu_torch -r rest --coordinator HOST:PORT \
        --num-processes 2 --process-id 0     # and --process-id 1

Rank r runs on ``cuda:(r % cards)``, or on the CPU with ``--device cpu``
(gloo); the backend is chosen as ``parallel.mesh`` says."""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GaussianCity PyTorch runner")
    p.add_argument("-e", "--exp", dest="exp_name", default=None,
                   help="experiment name")
    p.add_argument("-r", "--recipe", default="rest",
                   choices=["rest", "bldg", "car"],
                   help="model recipe (upstream README.md:125-167)")
    p.add_argument("-c", "--cfg", dest="cfg_file", default=None,
                   help="JSON config, in place of the recipe")
    p.add_argument("-d", "--dataset", default=None,
                   help="GOOGLE_EARTH | KITTI_360 | SYNTHETIC")
    p.add_argument("-p", "--ckpt", dest="ckpt", default=None,
                   help="checkpoint dir to load/resume")
    p.add_argument("--test", dest="test", action="store_true")
    p.add_argument("--inference", action="store_true",
                   help="render a city video from trained checkpoints "
                        "(upstream scripts/inference.py:672-707)")
    p.add_argument("--ckpt-rest", default=None,
                   help="REST (background) generator checkpoint dir")
    p.add_argument("--ckpt-bldg", default=None,
                   help="BLDG generator checkpoint dir")
    p.add_argument("--ckpt-car", default=None,
                   help="CAR generator checkpoint dir (KITTI-360)")
    p.add_argument("--city-dir", default=None,
                   help="city dir with Projection/ (+ CENTERS.pkl)")
    p.add_argument("--data-root", default=None,
                   help="dataset root; a random city is picked when "
                        "--city-dir is not given")
    p.add_argument("--output", default="output/video.mp4",
                   help="output video path (--inference)")
    p.add_argument("--frames", type=int, default=24,
                   help="number of orbit frames (--inference)")
    p.add_argument("--radius", type=int, default=None)
    p.add_argument("--altitude", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-points", type=int, default=262144,
                   help="per-frame visible point budget (--inference)")
    p.add_argument("--run-id", dest="run_id", default=None,
                   help="W&B run id; accepted, and without effect, as in "
                        "the JAX package")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT of the rendezvous of a data-parallel "
                        "run; rank 0 serves it (e.g. 127.0.0.1:29500)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="ranks of a data-parallel run, one process each")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank, 0 .. --num-processes - 1")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; rank r takes card "
                        "r %% cards) or cpu")
    return p


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def get_config(args: argparse.Namespace):
    """The recipe, replaced by ``-c``'s JSON config, then ``-e`` and
    ``-d``."""
    from gaussiancity_tpu_torch import config as cfg_mod

    cfg = {"rest": cfg_mod.rest_recipe, "bldg": cfg_mod.bldg_recipe,
           "car": cfg_mod.car_recipe}[args.recipe]()
    if args.cfg_file:
        with open(args.cfg_file) as f:
            cfg = cfg_mod.Config.from_json(f.read())
    if args.exp_name:
        cfg = cfg.replace(exp_name=args.exp_name)
    if args.dataset == "SYNTHETIC":
        cfg = cfg.replace(dataset=cfg.dataset.replace(name="SYNTHETIC"))
    elif args.dataset and args.dataset != cfg.dataset.name:
        cfg = cfg.replace(dataset=cfg_mod.kitti_360_dataset()
                          if args.dataset == "KITTI_360"
                          else cfg_mod.google_earth_dataset())
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> int:
    t_main = time.time()
    args = get_args(argv)
    logging.basicConfig(
        format="[%(levelname)s] %(asctime)s %(message)s", level=logging.INFO)
    if args.inference and (args.num_processes or 1) > 1:
        raise ValueError("--inference renders on one process: the frame "
                         "sharded over ranks is parallel.sharded_infer")
    from gaussiancity_tpu_torch.parallel import mesh

    device = mesh.init_dist(args.coordinator, args.num_processes,
                            args.process_id, args.device)
    logging.info("device: %s", device)
    try:
        return run_mode(args, device, t_main)
    finally:
        if mesh.dist.is_initialized():
            mesh.dist.destroy_process_group()


def run_mode(args: argparse.Namespace, device, t_main: float) -> int:
    """Inference, ``--test`` or training, on ``device``."""
    if args.run_id:
        logging.info("--run-id %s has no effect: W&B logging is off, as in "
                     "the JAX package", args.run_id)
    cfg = get_config(args)

    if args.inference:
        return run_inference(args, device, t_main)

    if args.test:
        if not args.ckpt:
            raise ValueError("--test requires -p/--ckpt")
        from gaussiancity_tpu_torch.data.datasets import (DataLoader,
                                                          get_dataset)
        from gaussiancity_tpu_torch.training import checkpoint as ckpt
        from gaussiancity_tpu_torch.training.step import Trainer
        from gaussiancity_tpu_torch.training.test import test as run_test

        loader = DataLoader(get_dataset(cfg, cfg.dataset.name, "val"),
                            batch_size=1, shuffle=False)
        trainer = Trainer(cfg, device=device, seed=cfg.train.seed)
        _, epoch = ckpt.restore_checkpoint(args.ckpt, trainer)
        run_test(cfg, trainer, loader, epoch=epoch)
    else:
        from gaussiancity_tpu_torch.parallel import mesh
        from gaussiancity_tpu_torch.training.checkpoint import state_digest
        from gaussiancity_tpu_torch.training.train import train

        trainer = train(cfg, dataset_name=cfg.dataset.name,
                        resume_from=args.ckpt, max_steps=args.max_steps,
                        device=device)
        if mesh.get_world_size() > 1:
            logging.info("rank %d of %d: replica digest %s", mesh.get_rank(),
                         mesh.get_world_size(), state_digest(trainer))
    return 0


def frame_dir(output: str) -> str:
    """Where ``--inference`` writes the frame jpgs: ``<output stem>_frames``
    beside the video."""
    return os.path.splitext(os.path.abspath(output))[0] + "_frames"


def run_inference(args: argparse.Namespace, device, t_main: float) -> int:
    """Checkpoint directories + a city directory -> an orbit video at
    ``--output`` and its frames as ``<output stem>_frames/%04d.jpg``
    (upstream scripts/inference.py:614-707).  Logs one line of timings."""
    import cv2
    import numpy as np
    import torch

    from gaussiancity_tpu_torch.inference.loader import (
        get_city_projections, get_models, get_random_city)
    from gaussiancity_tpu_torch.inference.pipeline import (
        InferencePipeline, get_orbit_camera_poses, get_style_lut,
        write_video)

    timings = {"main_wall_time": t_main, "imports_wall_time": time.time()}

    ckpt_dirs = {name: d for name, d in (
        ("REST", args.ckpt_rest), ("BLDG", args.ckpt_bldg),
        ("CAR", args.ckpt_car)) if d}
    if not ckpt_dirs and args.ckpt:
        ckpt_dirs["REST"] = args.ckpt
    if not ckpt_dirs:
        raise ValueError("--inference requires at least one of --ckpt-rest "
                         "/ --ckpt-bldg / --ckpt-car (or -p)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    cfg, models, z_banks = get_models(ckpt_dirs, device=device)
    timings["checkpoint_load_s"] = time.perf_counter() - t
    rng = np.random.default_rng(args.seed)

    t = time.perf_counter()
    city_dir = args.city_dir or get_random_city(args.data_root, rng)
    logging.info("rendering city: %s", city_dir)
    projections, centers = get_city_projections(city_dir)
    timings["projections_s"] = time.perf_counter() - t

    # several generators: each sees only its own class's points, nearest
    # first within --max-points (upstream scripts/inference.py:455-507)
    budgets = ({name: args.max_points for name in models}
               if len(models) > 1 else None)
    pipeline = InferencePipeline(cfg, models, max_points=args.max_points,
                                 class_budgets=budgets, device=device)
    # orbit the loaded map's centre (upstream takes PROJ_SIZE // 2, its
    # cities being proj_size wide)
    map_hw = next(iter(projections.values()))["SEG"].shape
    poses = get_orbit_camera_poses(
        max(map_hw), n_points=args.frames, radius=args.radius,
        altitude=args.altitude, rng=rng,
        center=(map_hw[1] // 2, map_hw[0] // 2))
    z_dim = cfg.network.z_dim
    for name in ("BLDG", "CAR"):
        if name in models and models[name].cfg.z_dim:
            z_dim = models[name].cfg.z_dim
    style_lut = get_style_lut(
        centers, z_dim or 1,
        z_bank=z_banks.get("BLDG") or z_banks.get("CAR"), seed=args.seed)

    frames = pipeline.render_trajectory(projections, centers, poses,
                                        style_lut=style_lut)
    t = time.perf_counter()
    write_video(args.output, frames)
    timings["video_write_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out_dir = frame_dir(args.output)
    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(frames):
        if not cv2.imwrite(os.path.join(out_dir, "%04d.jpg" % i),
                           f[..., ::-1]):
            raise OSError(f"could not write frame {i} to {out_dir}")
    timings["jpg_write_s"] = time.perf_counter() - t

    stages = pipeline.stage_ms
    per_frame = [ms for stage, ms in stages.items()
                 if len(ms) == len(poses) and stage not in ("extrude",
                                                            "volume")
                 and not stage.startswith("generator_")]
    frame_ms = [sum(col) for col in zip(*per_frame)]
    timings.update(
        extrude_ms=sum(stages.get("extrude", [])),
        volume_ms=sum(stages.get("volume", [])),
        frame_ms=frame_ms, frame_ms_median=float(np.median(frame_ms)),
        peak_device_gib=(torch.cuda.max_memory_allocated(device) / 2 ** 30
                         if device.type == "cuda" else None),
        device=str(device))
    logging.info("wrote %d frames to %s (+ jpgs in %s)", len(frames),
                 args.output, out_dir)
    logging.info("inference timings: %s", json.dumps(timings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
