# -*- coding: utf-8 -*-
"""The port's dataset command line (``python3 -m
gaussiancity_tpu_torch.data.generate_dataset``) against the JAX package's
``scripts/generate_dataset.py``: with ``--skip-views`` both write the same
bytes (projection PNGs, metadata, camera poses and rig) for a Google Earth
capture and a KITTI-360 download, the JAX suite's fixtures, each package
on its own copy.  Then one small KITTI-360 drive end to end on the CPU
through the port alone (the JAX package's end to end is
``test_generate_dataset_cli.py``'s), and the card default."""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import generate_dataset as jgd  # noqa: E402

from gaussiancity_tpu_torch.data import dataset_generator as dg  # noqa: E402
from gaussiancity_tpu_torch.data import generate_dataset as gd  # noqa: E402
from gaussiancity_tpu_torch.testing import share_cpu_cores  # noqa: E402

from test_generate_dataset_cli import _kitti_download  # noqa: E402
from test_osm_ingest import make_capture  # noqa: E402

share_cpu_cores()


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dp, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dp, f), "rb") as fp:
                out[os.path.relpath(os.path.join(dp, f), root)] = fp.read()
    return out


def _ge_capture(root, city):
    cap, osm = make_capture(root, city=city)
    frames = [{"coordinate": {"longitude": 10.0 + 1e-4 * i,
                              "latitude": 45.0, "altitude": 120.0 + i},
               "fovVertical": 22.5} for i in range(3)]
    with open(os.path.join(cap, f"{city}.json"), "w") as fp:
        json.dump({"width": 960, "height": 540, "cameraFrames": frames}, fp)
    return cap, osm


def test_google_earth_skip_views_matches_jax(tmp_path):
    """A city name of its own: ``google_earth_projections`` memoises the
    OSM render by name in each package."""
    city = "PortCity-01-capture"
    trees = []
    for name, main, extra in (("port", gd.main, ["--device", "cpu"]),
                              ("jax", jgd.main, [])):
        root = tmp_path / name
        root.mkdir()
        cap, osm = _ge_capture(root, city)
        assert main(["-d", "GOOGLE_EARTH", "--data-dir", str(root),
                     "--osm-dir", osm, "--city", city, "--skip-views",
                     *extra]) == 0
        trees.append(_tree(cap))
    assert trees[0].keys() == trees[1].keys()
    for k in trees[1]:
        assert trees[0][k] == trees[1][k], k
    assert {"CameraPoses.csv", "CameraRig.json", "Projection/metadata.json",
            "Projection/REST-INS.png"} <= trees[0].keys()


def test_kitti_360_skip_views_matches_jax(tmp_path):
    trees = []
    for name, main, extra in (("port", gd.main, ["--device", "cpu"]),
                              ("jax", jgd.main, [])):
        root = tmp_path / name
        root.mkdir()
        data, drive = _kitti_download(root)
        assert main(["-d", "KITTI_360", "--data-dir", data, "--city", drive,
                     "--skip-views", *extra]) == 0
        trees.append(_tree(os.path.join(data, "processed")))
    assert trees[0].keys() == trees[1].keys()
    for k in trees[1]:
        assert trees[0][k] == trees[1][k], k


def test_kitti_360_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """The drive's two views at a quarter of the KITTI-360 sensor (352 x
    94 rays, the intrinsics scaled alike), so that the plain raycast of
    the CPU path stays within this file's time budget; the full sensor
    runs through the same code on the card in ``chip_smoke.py``.  Each
    view extrudes its own frustum crop: ``get_points_from_projections``
    runs once a view."""
    extrude = dg.get_points_from_projections
    crops = []

    def counted(*args, **kwargs):
        crops.append(args[2] if len(args) > 2 else kwargs["local_cords"])
        return extrude(*args, **kwargs)

    monkeypatch.setattr(dg, "get_points_from_projections", counted)
    monkeypatch.setitem(dg._SENSORS, "KITTI_360", (352, 94))
    monkeypatch.setitem(dg._DEFAULT_K, "KITTI_360",
                        dg._DEFAULT_K["KITTI_360"] * [[0.25], [0.25], [1]])
    data, drive = _kitti_download(tmp_path)
    assert gd.main(["-d", "KITTI_360", "--data-dir", data, "--city", drive,
                    "--vol-shape", "256", "256", "128",
                    "--device", "cpu"]) == 0
    city_dir = os.path.join(data, "processed", drive)
    with open(os.path.join(city_dir, "CameraPoses.csv")) as fp:
        assert len(fp.read().splitlines()) == 3  # header + 2 kept frames
    pkls = sorted(os.listdir(os.path.join(city_dir, "Points")))
    assert pkls == ["0000000000.pkl", "0000000010.pkl"]
    assert len(crops) == len(pkls)
    assert all(c is not None for c in crops)
    for name in pkls:
        with open(os.path.join(city_dir, "Points", name), "rb") as fp:
            view = pickle.load(fp)
        assert set(view) == {"prj", "vpm", "msk", "pts"}
        assert len(view["pts"]) > 0 and view["pts"].dtype == np.int64
        assert view["vpm"].shape == (94, 352)
        assert view["vpm"].max() == len(view["pts"]) - 1
        assert os.path.exists(os.path.join(
            city_dir, "InstanceImage", name.replace(".pkl", ".png")))


def test_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gd.main(["-d", "KITTI_360", "--data-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        gd.process_city("KITTI_360", str(tmp_path))
