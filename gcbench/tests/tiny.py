"""A throwaway benchmark at tiny sizes for the harness's CPU tests: a
``BENCHMARK.json`` and the configuration, traffic, limits and metric
files of its cells, written under a temporary root, in the layout the
harness finds by name.  The metric readers are the repository's."""

from __future__ import annotations

import json
import os
import shutil

from gcbench.reference.gct.config import (
    Config, DatasetConfig, DiscriminatorOptim, GaussianNetworkConfig,
    PTv3Config, RasterizerConfig, TrainConfig)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_PTV3 = dict(order=("cord",), stride=(2, 2), enc_depths=(1, 1, 1),
                 enc_channels=(8, 16, 32), enc_n_head=(1, 2, 4),
                 enc_patch_size=(32, 32, 32), dec_depths=(1, 1),
                 dec_channels=(8, 16), dec_n_head=(1, 2),
                 dec_patch_size=(32, 32), mlp_ratio=2.0)


def tiny_rest() -> Config:
    return Config(
        dataset=DatasetConfig(
            sensor_size=(96, 64), train_crop_size=(64, 48),
            test_crop_size=(64, 48), proj_size=32,
            cam_k=(60.0, 0, 48.0, 0, 60.0, 32.0, 0, 0, 1)),
        network=GaussianNetworkConfig(
            scale_factor=0.5, encoder="GLOBAL", encoder_out_dim=5,
            global_encoder_n_blocks=2, pos_emd="HASH_GRID",
            hash_grid_n_levels=4, hash_grid_level_dim=4,
            hash_grid_map_size=10, mlp_hidden_dim=16, dis_n_channel_base=8,
            ptv3=PTv3Config(enabled=False)),
        rasterizer=RasterizerConfig(tile_h=16, tile_w=16, tile_capacity=256,
                                    grad_budget=65536),
        train=TrainConfig(
            allow_random_vgg=True,
            perceptual_loss_layers=("relu_1_1", "relu_2_1"),
            perceptual_loss_weights=(0.5, 1.0),
            discriminator=DiscriminatorOptim(n_warmup_iters=4)))


def tiny_bldg(cfg: Config = None) -> Config:
    cfg = cfg or tiny_rest()
    return cfg.replace(network=cfg.network.replace(
        scale_factor=0.65, encoder=None, encoder_out_dim=3,
        pos_emd="SIN_COS", sin_cos_freq_bends=4, z_dim=16,
        ptv3=PTv3Config(dense_nbr_extent=64, **TINY_PTV3)))


def tiny_kitti() -> Config:
    """``tiny_rest`` on a KITTI-360-shaped dataset: its name (its class
    scales), flipped frames, its building and car ranges."""
    cfg = tiny_rest()
    return cfg.replace(dataset=cfg.dataset.replace(
        name="KITTI_360", flip_ud=True, bldg_range=(100, 10000),
        car_range=(10000, 16384), car_clsid=3,
        z_scale_special_classes=(1, 6)))


CITY = {"size": 96, "n_buildings": 4, "seed": 0}
TRAFFIC = {
    "tiny_shells": {"kind": "train", "sampler": "building_shells",
                    "city": CITY, "n_samples": 3, "points": 256,
                    "followed_steps": 2, "traced_steps": 2},
    "tiny_views": {"kind": "train", "sampler": "city_views", "city": CITY,
                   "n_samples": 3, "points": 256, "view_radius": 30,
                   "view_altitude": 30, "followed_steps": 2,
                   "traced_steps": 2},
    "tiny_orbit": {"kind": "frame", "city": CITY, "n_poses": 4,
                   "radius": 30, "altitude": 40, "point_budget": 4096,
                   "vol_shape": [96, 96, 128], "sample_frames": 2},
    "tiny_kitti_orbit": {"kind": "frame",
                         "city": dict(CITY, builder="tiny_kitti",
                                      n_cars=12),
                         "n_poses": 4, "radius": 30, "altitude": 40,
                         "point_budget": 4096, "vol_shape": [96, 96, 128],
                         "sample_frames": 2},
    "tiny_views_ddp2": {"kind": "train_ddp", "sampler": "city_views",
                        "city": CITY, "n_samples": 3, "points": 256,
                        "view_radius": 30, "view_altitude": 30, "world": 2,
                        "followed_steps": 2, "traced_steps": 2},
}
TRAIN_LIMITS = {"loss": 1e-5, "attrs": 1e-5, "crop": 1e-5, "grad.G": 1e-4,
                "grad.D": 1e-4, "change.G": 1e-3, "adam.D": 1e-4,
                "lr.D": 0}
FRAME_LIMITS = {"vis_rows": 0, "gauss": 1e-5, "frame_px": 0.001}
DDP_LIMITS = dict(TRAIN_LIMITS, replicas=0)
CELLS = [  # name, config, traffic, limits
    ("tiny_bldg.train", "tiny-bldg", "tiny_shells", TRAIN_LIMITS),
    ("tiny_rest.train", "tiny-rest", "tiny_views", TRAIN_LIMITS),
    ("tiny_city.frame", "tiny-bldg", "tiny_orbit", FRAME_LIMITS),
    ("tiny_rest.frame", "tiny-rest", "tiny_orbit", FRAME_LIMITS),
    ("tiny_kitti.frame", "tiny-kitti", "tiny_kitti_orbit", FRAME_LIMITS),
    ("tiny_rest.train.ddp2", "tiny-rest", "tiny_views_ddp2", DDP_LIMITS),
]
# a KITTI-360 deployment as one configuration: REST, with its BLDG and
# CAR generators under "models"
KITTI_MODELS = [("BLDG", tiny_bldg(tiny_kitti())),
                ("CAR", tiny_bldg(tiny_kitti()))]


def write_bench(root: str, cells=CELLS) -> dict:
    """Write the tiny benchmark under ``root``; returns its
    ``BENCHMARK.json``, whose metrics are the repository's."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        real = json.load(f)
    gc = os.path.join(root, "gcbench")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(gc, d), exist_ok=True)
    shutil.copytree(os.path.join(REPO, "gcbench", "metrics"),
                    os.path.join(gc, "metrics"), dirs_exist_ok=True)
    os.makedirs(os.path.join(gc, "cities"), exist_ok=True)
    shutil.copy(os.path.join(REPO, "gcbench", "tests", "tiny_kitti_city.py"),
                os.path.join(gc, "cities", "tiny_kitti.py"))
    confs = {"tiny-rest": ("REST", tiny_rest(), [], []),
             "tiny-bldg": ("BLDG", tiny_bldg(), ["tiny-rest"], []),
             "tiny-kitti": ("REST", tiny_kitti(), [], KITTI_MODELS)}
    for name, (model, cfg, comp, more) in confs.items():
        conf = {"name": name, "model": model, "companions": comp,
                "config": cfg.to_dict()}
        if more:
            conf["models"] = [{"model": m, "config": c.to_dict(),
                               "precision": ["compute", "params"]}
                              for m, c in more]
        with open(os.path.join(gc, "configs", f"{name}.json"), "w") as f:
            json.dump(conf, f)
    for name, t in TRAFFIC.items():
        with open(os.path.join(gc, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
    for name, _, _, lim in cells:
        with open(os.path.join(gc, "limits", f"{name}.json"), "w") as f:
            json.dump(lim, f)
    names = {c[0] for c in cells}

    def keep(m):
        if "workloads" not in m:
            return dict(m)
        ws = [w.replace("bldg.", "tiny_bldg.").replace("rest.", "tiny_rest.")
              .replace("city.", "tiny_city.").replace(".ddp4", ".ddp2")
              for w in m["workloads"]]
        # the three-generator KITTI frame cell reads what the two-generator
        # city frame cell reads
        if "tiny_city.frame" in ws:
            ws.append("tiny_kitti.frame")
        return dict(m, workloads=[w for w in ws if w in names])

    bench = {
        "command": real["command"], "paths": real["paths"],
        "run_seconds": 1,
        "configs": [{"name": n, "source": "test",
                     "file": f"gcbench/configs/{n}.json", "reduced": [],
                     "why": "tiny"} for n in confs],
        "workloads": [{"name": n, "config": c, "traffic": t,
                       "chips": TRAFFIC[t].get("world", 1), "why": "tiny"}
                      for n, c, t, _ in cells],
        "end_to_end": [keep(m) for m in real["end_to_end"]],
        "per_layer": [keep(m) for m in real["per_layer"]],
    }
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench


def run(root: str, name: str, seed: int = 1, seconds: float = 0.0,
        trace: bool = False):
    """One run of cell ``name`` on the CPU: (result, compared)."""
    import time

    from gcbench import harness

    harness.set_environment(root)
    cell = harness.find_cell(root, name)
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            time.perf_counter())
