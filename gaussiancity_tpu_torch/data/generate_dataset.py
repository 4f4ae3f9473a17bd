# -*- coding: utf-8 -*-
"""Offline dataset generation: raw captures -> training files (counterpart
of the JAX package's ``scripts/generate_dataset.py``; upstream
scripts/dataset_generator.py main, :1453-1727).

For every city under ``--data-dir``:

1. raw capture -> projection maps (``kitti_ingest.get_projections``: OSM
   renders + a Google Earth .esp project, or KITTI-360 3D-box XMLs),
   saved to ``<city>/Projection/`` with the georeference metadata;
2. camera rig + pose recovery -> ``<city>/CameraPoses.csv`` and
   ``CameraRig.json``;
3. per view, extrusion (kernel E1), the id volume and its raycast (kernel
   V1) on ``--device`` -> ``<city>/Points/*.pkl`` and
   ``<city>/InstanceImage/*.png`` (``dataset_generator.generate_city``).

KITTI-360 downloads are first reorganised into per-drive capture dirs
(``reorganize_kitti_360``).  Usage::

    python3 -m gaussiancity_tpu_torch.data.generate_dataset \\
        -d GOOGLE_EARTH --data-dir data/google-earth --osm-dir data/osm
    python3 -m gaussiancity_tpu_torch.data.generate_dataset \\
        -d KITTI_360 --data-dir data/kitti --device cpu
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from gaussiancity_tpu_torch.data import dataset_generator as dg
from gaussiancity_tpu_torch.data import kitti_ingest as ki
from gaussiancity_tpu_torch.data.camera_recovery import \
    recover_camera_parameters
from gaussiancity_tpu_torch.device import resolve_device


def process_city(dataset: str, city_dir: str, osm_dir=None,
                 vol_shape=(640, 640, 256), skip_views=False,
                 device=None) -> None:
    """One city: projections, camera poses and (unless ``skip_views``)
    the views on ``device`` (the card unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    proj_dir = os.path.join(city_dir, "Projection")
    logging.info("[%s] projections...", os.path.basename(city_dir))
    metadata, projections = ki.get_projections(dataset, city_dir, osm_dir)
    dg.dump_projections(projections, proj_dir)
    with open(os.path.join(proj_dir, "metadata.json"), "w") as fp:
        json.dump(metadata, fp)

    logging.info("[%s] camera poses...", os.path.basename(city_dir))
    rig, poses = recover_camera_parameters(dataset, city_dir, metadata)
    dg.save_camera_poses(os.path.join(city_dir, "CameraPoses.csv"), poses)
    with open(os.path.join(city_dir, "CameraRig.json"), "w") as fp:
        json.dump(rig, fp)

    if skip_views:
        return
    # CameraPoses.csv stores target-relative xy (what the training loader
    # expects: datasets.py adds MAP_SIZE/2 back); the view generator wants
    # map coordinates, so re-centre here as upstream's main does
    # (:1540-1543)
    c = dg.CONSTANTS[dataset]
    offset = c["MAP_SIZE"] // 2
    map_poses = [dict(p, tx=float(p["tx"]) / c["SCALE"] + offset,
                      ty=float(p["ty"]) / c["SCALE"] + offset)
                 for p in poses]
    logging.info("[%s] %d views...", os.path.basename(city_dir),
                 len(map_poses))
    dg.generate_city(dataset, city_dir, cam_poses=map_poses,
                     vol_shape=vol_shape, device=device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-d", "--dataset", required=True,
                   choices=["GOOGLE_EARTH", "KITTI_360"])
    p.add_argument("--data-dir", required=True,
                   help="root of capture dirs (GOOGLE_EARTH) or the raw "
                        "KITTI-360 download")
    p.add_argument("--osm-dir", default=None,
                   help="OSM render root (GOOGLE_EARTH only)")
    p.add_argument("--city", default=None,
                   help="process only this city/drive")
    p.add_argument("--vol-shape", type=int, nargs=3,
                   default=(640, 640, 256),
                   help="extrusion volume (W H D)")
    p.add_argument("--skip-views", action="store_true",
                   help="stop after projections + camera poses")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        format="[%(levelname)s] %(asctime)s %(message)s", level=logging.INFO)
    device = resolve_device(args.device)

    data_dir = args.data_dir
    if args.dataset == "KITTI_360":
        data_dir = ki.reorganize_kitti_360(data_dir)
    cities = [args.city] if args.city else sorted(
        c for c in os.listdir(data_dir)
        if os.path.isdir(os.path.join(data_dir, c)))
    for city in cities:
        if city == "DONE":
            continue
        process_city(args.dataset, os.path.join(data_dir, city),
                     args.osm_dir, tuple(args.vol_shape), args.skip_views,
                     device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
