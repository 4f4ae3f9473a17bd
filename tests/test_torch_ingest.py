# -*- coding: utf-8 -*-
"""The port's raw-capture ingest against the JAX package's, on the JAX
suite's synthetic fixtures: ``osm_ingest`` (instance map, stride mask,
OSM loading, the .esp camera target, the building registry, the Google
Earth projections), ``camera_recovery`` (web mercator, look-at
quaternions, the Google Earth rig and poses, the KITTI-360 calibration
and poses), ``cleaning`` (seg-map discretising, roof textures, roof and
asphalt cleaning, each package's numpy and ``random`` state seeded alike
before its call) and ``kitti_ingest`` (mesh readers, the SAT voxeliser,
the annotation meshes, the XML -> projection pipeline, the download's
reorganisation).  Arrays, JSON and poses are held equal, dtypes too."""

import os
import pickle
import random

import numpy as np
import pytest

from gaussiancity_tpu.data import camera_recovery as jcr
from gaussiancity_tpu.data import cleaning as jcl
from gaussiancity_tpu.data import kitti_ingest as jki
from gaussiancity_tpu.data import osm_ingest as joi

from gaussiancity_tpu_torch.data import camera_recovery as cr
from gaussiancity_tpu_torch.data import cleaning as cl
from gaussiancity_tpu_torch.data import kitti_ingest as ki
from gaussiancity_tpu_torch.data import osm_ingest as oi
from gaussiancity_tpu_torch.testing import share_cpu_cores

from test_camera_recovery import TestGoogleEarthRecovery
from test_generate_dataset_cli import _kitti_download
from test_kitti_ingest import _bbox_vertices
from test_kitti_ingest import city  # noqa: F401  (fixture)
from test_osm_ingest import make_capture

share_cpu_cores()

GE = "GOOGLE_EARTH"


def assert_same(got, want, path="out"):
    """Equal structure, values and dtypes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _seg(seed, shape=(48, 40), classes=(0, 1, 2, 3, 4, 5, 6)):
    rng = np.random.default_rng(seed)
    seg = rng.choice(classes, shape).astype(np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
        seg[y:y + 8, x:x + 6] = 2
    return seg


class TestOsmIngest:
    def test_instance_map_and_stride_masks(self):
        seg = _seg(0)
        assert_same(oi.build_instance_map(seg), joi.build_instance_map(seg))
        for dataset in (GE, "KITTI_360"):
            assert_same(oi.point_stride_mask(seg, dataset),
                        joi.point_stride_mask(seg, dataset))

    def test_registry_and_camera_target(self):
        reg, jreg = oi.BuildingInstanceRegistry(), \
            joi.BuildingInstanceRegistry()
        for m in (np.array([[1, 300], [302, 302]]),
                  np.array([[300, 310], [5, 400]])):
            assert_same(reg.reassign(m), jreg.reassign(m))
        assert reg.mapping == jreg.mapping
        esp = {"scenes": [{"attributes": [
            {"type": "cameraGroup", "attributes": [
                {"type": "cameraTargetEffect", "attributes": [
                    {"type": "poi", "attributes": [
                        {"type": "longitudePOI", "value": {"relative": 0.3}},
                        {"type": "altitudePOI", "value": {"relative": 9.5}},
                    ]}]}]}]}]}
        meta = {"clat": 45.5}
        assert_same(oi.get_camera_target(esp, meta),
                    joi.get_camera_target(esp, meta))

    def test_google_earth_projections(self, tmp_path):
        """The 4096-pixel OSM render of ``test_osm_ingest.make_capture``,
        its 2048-pixel window; each package's call gets its own memo."""
        cap, osm = make_capture(tmp_path)
        got = oi.google_earth_projections(cap, osm, _cache={})
        want = joi.google_earth_projections(cap, osm, _cache={})
        assert_same(got, want)
        assert got[1]["REST"]["INS"].max() >= 100
        td, seg, ins, meta = oi.load_osm_city(osm, "TestCity-01")
        assert_same((td, seg, ins, meta),
                    joi.load_osm_city(osm, "TestCity-01"))


class TestCameraRecovery:
    def test_web_mercator_and_look_at(self):
        rng = np.random.default_rng(0)
        lng, lat = rng.uniform(-179, 179, 20), rng.uniform(-80, 80, 20)
        assert_same(cr.lnglat_to_web_mercator_xy(lng, lat, 1.5, 18),
                    jcr.lnglat_to_web_mercator_xy(lng, lat, 1.5, 18))
        pos = rng.uniform(-100, 100, (6, 3))
        pos[0] = [0.0, 0.0, 50.0]  # straight down onto the target
        assert_same(cr.look_at_quats(pos, np.zeros(3)),
                    jcr.look_at_quats(pos, np.zeros(3)))

    def test_google_earth_rig_and_poses(self, tmp_path):
        city, _ = TestGoogleEarthRecovery()._city(tmp_path)
        tx0, ty0 = jcr.lnglat_to_web_mercator_xy(10.0, 50.0, 2.0)
        metadata = {
            "resolution": 2.0,
            "bounds": {"xmin": float(tx0) - 1000, "ymin": float(ty0) - 1000},
            "target": {"x": 700.0, "y": 950.0, "z": 0.0}}
        assert_same(cr.recover_camera_parameters(GE, city, metadata),
                    jcr.recover_camera_parameters(GE, city, metadata))

    def test_kitti_360_calibration_and_poses(self, tmp_path):
        root, drive = _kitti_download(tmp_path)
        seq = os.path.join(root, "data_poses", drive)
        os.makedirs(os.path.join(root, "calibration"), exist_ok=True)
        metadata = {"bounds": {"xmin": 5.0, "ymin": -3.0, "zmin": 1.0}}
        # the sequence dir sits two levels below the calibration
        assert_same(cr.recover_camera_parameters("KITTI_360", seq, metadata),
                    jcr.recover_camera_parameters("KITTI_360", seq,
                                                  metadata))
        with pytest.raises(ValueError):
            cr.recover_camera_parameters("NOPE", seq, metadata)


def _roof_scene(seed):
    """Two footages with buildings 102 and 104 (facade) and their roofs
    (103, 105), coloured so that the kmeans finds facade colours."""
    rng = np.random.default_rng(seed)
    footages, segs = [], []
    for _ in range(2):
        img = rng.integers(0, 120, (48, 64, 3)).astype(np.uint8)
        seg = np.ones((48, 64), np.int32)
        seg[4:20, 4:24], seg[20:30, 4:24] = 102, 103
        seg[26:44, 34:60], seg[8:22, 36:58] = 104, 105
        img[seg == 102] = rng.integers(150, 255, 3)
        img[seg == 104] = rng.integers(140, 250, 3)
        footages.append(img)
        segs.append(seg)
    textures = [rng.integers(0, 255, (96, 96, 3)).astype(np.uint8)
                for _ in range(2)]
    return footages, segs, textures


class TestCleaning:
    def test_discretize_and_texture(self):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
        assert_same(cl.discretize_seg_map(img), jcl.discretize_seg_map(img))
        assert_same(cl.downsample_texture(img), jcl.downsample_texture(img))

    def test_clean_roofs(self):
        footages, segs, textures = _roof_scene(1)
        texture = cl.downsample_texture(textures[0])
        out = []
        for mod in (cl, jcl):
            np.random.seed(3)  # scipy's kmeans draws from numpy's state
            out.append(mod.clean_roofs(footages, segs, [texture * 0.9,
                                                        texture],
                                       rng=random.Random(7)))
        assert_same(*out)
        assert any((o != f).any() for o, f in zip(out[0], footages))

    def test_clean_asphalt(self, tmp_path):
        rng = np.random.default_rng(2)
        asphalt = rng.integers(0, 255, (80, 90, 3)).astype(np.uint8)
        roots = []
        for name in ("port", "jax"):
            from PIL import Image

            d = tmp_path / name
            for sub in ("footage", "InstanceImage", "Points"):
                (d / sub).mkdir(parents=True)
            r = np.random.default_rng(5)
            for i in range(2):
                Image.fromarray(r.integers(0, 255, (24, 32, 3)).astype(
                    np.uint8)).save(d / "footage" / f"{i:04d}.png")
                ins = r.integers(0, 3, (24, 32)).astype(np.uint16)
                Image.fromarray(ins).save(d / "InstanceImage" / f"{i:04d}.png")
                with open(d / "Points" / f"{i:04d}.pkl", "wb") as fp:
                    pickle.dump({"msk": np.zeros((24, 32), bool)}, fp)
            roots.append(str(d))
        assert cl.clean_asphalt(roots[0], asphalt) == \
            jcl.clean_asphalt(roots[1], asphalt) == 2
        for sub in ("footage", "Points"):
            for f in sorted(os.listdir(os.path.join(roots[0], sub))):
                a, b = (open(os.path.join(r, sub, f), "rb").read()
                        for r in roots)
                assert a == b, (sub, f)


class TestKittiIngest:
    def test_mesh_readers(self, tmp_path):
        (tmp_path / "m.obj").write_text(
            "# c\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n"
            "f 1//1 2/2/2 3\n")
        (tmp_path / "m.ply").write_text(
            "ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
            "property float y\nproperty float z\nelement face 1\n"
            "property list uchar int vertex_indices\nend_header\n"
            "0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
        for name in ("m.obj", "m.ply"):
            path = str(tmp_path / name)
            assert_same(ki.read_triangle_mesh(path),
                        jki.read_triangle_mesh(path))

    @pytest.mark.parametrize("seed", [0, 1])
    def test_voxeliser(self, seed):
        rng = np.random.default_rng(seed)
        v = rng.random((6, 3)) * 2.0
        f = np.array([[0, 1, 2], [3, 4, 5], [0, 4, 2]])
        assert_same(ki.voxelize_triangle_mesh(v, f, 0.1),
                    jki.voxelize_triangle_mesh(v, f, 0.1))

    def test_annotation_meshes(self, tmp_path):
        v = _bbox_vertices(w=4.0, d=10.0, h=9.0, angle=0.3)
        assert_same(ki.make_building_mesh(v), jki.make_building_mesh(v))
        v = _bbox_vertices(w=2.0, d=6.0, h=2.0, offset=(5, 3, 1))
        assert_same(ki.make_car_mesh(v), jki.make_car_mesh(v))
        (tmp_path / "tree.obj").write_text(
            "v 0 0 0\nv 1 0 0\nv 1 2 0\nv 0 2 1\nf 1 2 3\nf 1 3 4\n")
        v = _bbox_vertices(w=10.0, d=12.0, h=8.0)
        ring = v[[0, 2, 4, 6], :2]
        verts = np.concatenate([
            np.concatenate([ring, np.zeros((4, 1))], axis=1),
            np.concatenate([ring, np.full((4, 1), 8.0)], axis=1)])
        f = ki._prism_faces(4)
        assert_same(ki.make_tree_mesh(verts, f, ki.TreeAssets(str(tmp_path)),
                                      np.random.default_rng(0)),
                    jki.make_tree_mesh(verts, f,
                                       jki.TreeAssets(str(tmp_path)),
                                       np.random.default_rng(0)))

    def test_xml_to_projections(self, city):  # noqa: F811
        drive = os.path.basename(city)
        xml = os.path.join(os.path.dirname(os.path.dirname(city)),
                           "data_3d_bboxes", "train_full", f"{drive}.xml")
        ann = ki.parse_kitti_annotations(xml)
        jann = jki.parse_kitti_annotations(xml)
        assert_same(ann, jann)
        pts = ki.annotations_to_points(ann)
        assert_same(pts, jki.annotations_to_points(jann))
        assert_same(ki.project_points(*pts), jki.project_points(*pts))
        assert_same(ki.get_projections("KITTI_360", city),
                    jki.get_projections("KITTI_360", city))

    def test_merge_and_reorganise(self, tmp_path):
        p = {k: np.arange(16, dtype=np.int16).reshape(4, 4)
             for k in ("INS", "SEG", "TD_HF", "BU_HF")}
        p["PTS"] = np.ones((4, 4), bool)
        meta = {"A": {"bounds": {"xmin": 0, "ymin": 0, "zmin": 0}},
                "B": {"bounds": {"xmin": 5, "ymin": 2, "zmin": 3}}}
        assert_same(
            ki.merge_projections(meta, {c: dict(p) for c in "AB"}),
            jki.merge_projections(meta, {c: dict(p) for c in "AB"}))
        trees = []
        for name in ("port", "jax"):
            d = tmp_path / name
            d.mkdir()
            root, _ = _kitti_download(d)
            out = (ki if name == "port" else jki).reorganize_kitti_360(root)
            assert out == os.path.join(root, "processed")
            trees.append({os.path.relpath(os.path.join(dp, f), out):
                          open(os.path.join(dp, f), "rb").read()
                          for dp, _, fs in os.walk(out) for f in fs})
        assert trees[0] == trees[1] and len(trees[0]) > 3
