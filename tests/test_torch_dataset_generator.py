# -*- coding: utf-8 -*-
"""The port's dataset generation (``gaussiancity_tpu_torch/data/
dataset_generator.py``) against the JAX package's: projection PNGs,
instance centres, extruded points, each view's maps and points, the
city's files, and the ``GoogleEarthDataset`` items read from them; and
``visibility.get_visible_points`` / ``RaycastResult.raydirs``.

The city is ``test_dataset_generator.synthetic_city`` (P 96) at the volume
(128, 128, 48), seen from the poses of ``test_ge_end_to_end._make_city``,
with the local projection window cut to 128 in both packages.  Those poses
look along the map's x axis, where the JAX march's near-axis fault shows,
and on any view its column march lands a few corner-grazing rays off the
cell-by-cell DDA (ROADMAP Queue 3): the reference is corrected as
``test_torch_visibility.py::TestRaycast::test_near_axis_rays`` does, by
holding the pixels where the two packages differ to the JAX suite's
scalar DDA (``exact_visible_from_volume``)."""

import csv
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiancity_tpu.camera import quat_xyzw_to_matrix as j_quat_to_matrix
from gaussiancity_tpu.config import DatasetConfig as JDatasetConfig
from gaussiancity_tpu.config import Config as JConfig
from gaussiancity_tpu.config import TrainConfig as JTrainConfig
from gaussiancity_tpu.data import dataset_generator as jdg
from gaussiancity_tpu.data.datasets import get_dataset as j_get_dataset
from gaussiancity_tpu.inference.pipeline import get_quat_from_look_at
from gaussiancity_tpu.ops import visibility as jvis

from gaussiancity_tpu_torch.config import Config, DatasetConfig, TrainConfig
from gaussiancity_tpu_torch.data import dataset_generator as dg
from gaussiancity_tpu_torch.data.datasets import get_dataset
from gaussiancity_tpu_torch.ops import visibility as vis
from gaussiancity_tpu_torch.testing import share_cpu_cores

from test_dataset_generator import synthetic_city
from test_extrusion_visibility import numpy_dda

share_cpu_cores()

VOL = (128, 128, 48)
WINDOW = 128  # the local projection window of both packages in this file
N_VIEWS = 2
# share of a view's pixels that the near-axis correction may touch
MAX_CORRECTED = 0.01

_jax_visible_from_volume = jvis.visible_from_volume


@functools.lru_cache(maxsize=None)
def _jax_visible_fn(cam_f, cam_c, img_dims):
    """The JAX ``visible_from_volume``, jitted for one camera."""
    return jax.jit(functools.partial(_jax_visible_from_volume, cam_f=cam_f,
                                     cam_c=cam_c, img_dims=img_dims))


@functools.lru_cache(maxsize=None)
def _jax_raydirs_fn(cam_f, cam_c, img_dims):
    """The JAX ray directions of one camera: its march, cut to one step,
    returns them as the whole march does."""
    return jax.jit(functools.partial(jvis.ray_voxel_intersection,
                                     cam_f=cam_f, cam_c=cam_c,
                                     img_dims=img_dims, max_steps=1))


def _scalar_first_hit(vol, ori, rd, ztop):
    """One ray as the JAX march documents it: from above the highest
    occupied layer the ray starts at its crossing of ztop + 0.5 (upward
    rays miss), then the JAX suite's scalar DDA.  Returns the voxel id."""
    o, rd = np.float32(ori), np.float32(rd)
    z_land = np.float32(ztop + 0.5)
    if o[2] > z_land:
        if rd[2] >= 0:
            return 0
        t = max(np.float32((z_land - o[2]) / rd[2]), np.float32(0))
        o = (o + np.float32(t) * rd).astype(np.float32)
    return numpy_dda(vol, o, rd)[0]


def exact_visible_from_volume(vol, points, cam_pos, cam_quat, cam_f, cam_c,
                              img_dims, offsets, occupancy=None):
    """The JAX ``visible_from_volume`` with its march's faults corrected:
    where its point map differs from the port's, the pixels must be few
    and each takes the scalar DDA's hit along the JAX ray direction.
    Returns numpy (vp_map, ins_map)."""
    cam = (float(cam_f), tuple(map(float, cam_c)), tuple(img_dims))
    vp, ins = _jax_visible_fn(*cam)(vol, points, cam_pos, cam_quat,
                                    offsets=offsets, occupancy=occupancy)
    vp, ins = np.array(vp), np.array(ins)
    vol_np, pts_np = np.array(vol), np.array(points)
    f32 = dict(dtype=torch.float32)
    got, _ = vis.visible_from_volume(
        torch.from_numpy(vol_np), torch.from_numpy(pts_np),
        torch.tensor(np.array(cam_pos), **f32),
        torch.tensor(np.array(cam_quat), **f32), cam_f, cam_c, img_dims,
        torch.tensor(np.array(offsets)))
    bad = np.argwhere(vp != got.numpy())
    if not len(bad):
        return vp, ins
    # the JAX visible_from_volume's ray origin and direction
    cam_loc = (np.asarray(cam_pos) - np.asarray(offsets)).astype(np.float32)
    look = np.asarray(j_quat_to_matrix(
        jnp.asarray(cam_quat, jnp.float32)))[:, 0]
    ori = np.float32([cam_loc[1], cam_loc[0], cam_loc[2]])
    vdir = np.float32([look[1], look[0], look[2]])
    assert len(bad) <= MAX_CORRECTED * vp.size, len(bad)
    rds = np.asarray(_jax_raydirs_fn(*cam)(
        jnp.asarray(vol_np), jnp.asarray(ori), jnp.asarray(vdir),
        jnp.asarray([0.0, 0.0, 1.0])).raydirs)
    ztop = float(jvis.pack_occupancy(jnp.asarray(vol_np))[1])
    for py, px in bad:
        hit = _scalar_first_hit(vol_np, ori, rds[py, px], ztop)
        vp[py, px] = hit - 1
        ins[py, px] = pts_np[hit - 1, 4] if hit else 0
    return vp, ins


def _poses():
    """The poses of test_ge_end_to_end._make_city."""
    poses = []
    for i in range(N_VIEWS):
        pos = np.array([20.0 + 4 * i, 48.0, 30.0])
        q = get_quat_from_look_at(pos, np.array([48.0, 48.0, 1.0]))
        poses.append({"id": i, "tx": pos[0], "ty": pos[1], "tz": pos[2],
                      "qx": q[0], "qy": q[1], "qz": q[2], "qw": q[3]})
    return poses


def record_calls(mp, target, name, store):
    """Wrap ``target.name`` through the monkeypatch ``mp`` to keep what
    each call returns in ``store``."""
    fn = getattr(target, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        store.append(out)
        return out
    mp.setattr(target, name, wrapped)


@pytest.fixture(scope="module")
def cities(tmp_path_factory):
    """The synthetic city generated by each package into its own root:
    (JAX root, port root, JAX views, port views), a view being (the
    Points pkl dict, the instance map)."""
    from PIL import Image

    roots = {k: str(tmp_path_factory.mktemp(k)) for k in ("jax", "port")}
    views = {"jax": [], "port": []}
    rng = np.random.default_rng(0)
    footage = [rng.integers(0, 255, (540, 960, 3), np.uint8)
               for _ in range(N_VIEWS)]
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jdg, dg):
            mp.setitem(mod.CONSTANTS["GOOGLE_EARTH"], "PROJECTION_SIZE",
                       WINDOW)
        mp.setattr(jvis, "visible_from_volume", exact_visible_from_volume)
        record_calls(mp, jdg, "generate_view", views["jax"])
        record_calls(mp, dg, "generate_view", views["port"])
        for key, mod in (("jax", jdg), ("port", dg)):
            city = os.path.join(roots[key], "TestCity")
            os.makedirs(os.path.join(city, "footage"))
            projections = synthetic_city(city)  # written by the JAX package
            if mod is dg:
                dg.dump_projections(projections,
                                    os.path.join(city, "Projection"))
            mod.save_camera_poses(os.path.join(city, "CameraPoses.csv"),
                                  _poses())
            if mod is dg:
                dg.generate_city("GOOGLE_EARTH", city, vol_shape=VOL,
                                 device="cpu")
            else:
                jdg.generate_city("GOOGLE_EARTH", city, vol_shape=VOL)
            for i, img in enumerate(footage):
                Image.fromarray(img).save(
                    os.path.join(city, "footage", f"TestCity_{i:02d}.jpeg"))
    return roots["jax"], roots["port"], views["jax"], views["port"]


def _kitti_projections(P=64, seed=3):
    """REST and CAR maps on the KITTI-360 id ranges: two buildings, a car
    (10005) and sky, with heights and bottoms."""
    rng = np.random.default_rng(seed)
    ins = np.ones((P, P), np.int16)
    ins[4:14, 6:18] = 100
    ins[30:44, 20:30] = 102
    ins[50:, 50:] = 5
    td = np.where(ins >= 100, 12, 1).astype(np.int16)
    td[30:44, 20:30] = 20
    car = np.zeros((P, P), np.int16)
    car[20:24, 40:48] = 10005
    return {
        "REST": {"INS": ins, "SEG": np.where(ins >= 100, 2, ins).astype(
            np.int16), "TD_HF": td, "BU_HF": np.zeros((P, P), np.int16),
            "PTS": (rng.random((P, P)) > 0.1).astype(np.int16)},
        "CAR": {"INS": car, "SEG": np.where(car > 0, 3, 0).astype(np.int16),
                "TD_HF": np.where(car > 0, 4, 0).astype(np.int16),
                "BU_HF": np.where(car > 0, 1, 0).astype(np.int16),
                "PTS": (car > 0).astype(np.int16)}}


def _assert_same(got, want, path="item"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)


class TestTables:
    def test_tables_and_relations_match_jax(self):
        assert dg.CLASSES == jdg.CLASSES and dg.SCALES == jdg.SCALES
        assert dg.CONSTANTS == jdg.CONSTANTS
        for name in ("GOOGLE_EARTH", "KITTI_360"):
            assert dg.class_scale_table(name) == jdg.class_scale_table(name)
            assert (tuple(dg.get_seg_ins_relations(name))
                    == tuple(jdg.get_seg_ins_relations(name)))
            np.testing.assert_array_equal(dg.camera_intrinsics(name),
                                          jdg.camera_intrinsics(name))
            assert dg.sensor_size(name) == jdg.sensor_size(name)
            assert (dg.helpers_intrinsic_fov(name, 0)
                    == jdg.helpers_intrinsic_fov(name, 0))
        q = _poses()[1]
        quat = np.array([q["qx"], q["qy"], q["qz"], q["qw"]])
        np.testing.assert_array_equal(dg.look_dir(quat), jdg.look_dir(quat))

    def test_projection_pngs_cross_read(self, tmp_path):
        projections = _kitti_projections()
        jdg.dump_projections(projections, str(tmp_path / "jax"))
        dg.dump_projections(projections, str(tmp_path / "port"))
        for key, load in (("jax", dg.load_projections),
                          ("port", jdg.load_projections)):
            loaded = load(str(tmp_path / key))
            assert loaded.keys() == projections.keys()
            for c, maps in projections.items():
                for m, arr in maps.items():
                    assert loaded[c][m].dtype == np.int16
                    np.testing.assert_array_equal(loaded[c][m], arr)
        for name in os.listdir(tmp_path / "jax"):
            assert ((tmp_path / "jax" / name).read_bytes()
                    == (tmp_path / "port" / name).read_bytes()), name

    @pytest.mark.parametrize("dataset", ["GOOGLE_EARTH", "KITTI_360"])
    def test_centers_match_jax(self, dataset, tmp_path):
        projections = (synthetic_city(str(tmp_path))
                       if dataset == "GOOGLE_EARTH" else _kitti_projections())
        want = jdg.get_centers_from_projections(dataset, projections)
        got = dg.get_centers_from_projections(dataset, projections)
        _assert_same(got, want, "centers")
        if dataset == "KITTI_360":
            assert 10005 in got and dg.CLASSES[dataset]["SKY"] in got

    def test_seg_map_from_ins_map_matches_jax(self):
        ins = np.array([[0, 1, 5, 100, 101], [9999, 10000, 10005, 16383,
                                              16384]], np.int32)
        for dataset in ("GOOGLE_EARTH", "KITTI_360"):
            _assert_same(dg.get_seg_map_from_ins_map(dataset, ins),
                         jdg.get_seg_map_from_ins_map(dataset, ins))


class TestPoints:
    def test_points_match_jax(self, tmp_path):
        projections = synthetic_city(str(tmp_path))
        _assert_same(
            dg.get_points_from_projections("GOOGLE_EARTH", projections,
                                           device="cpu").numpy(),
            jdg.get_points_from_projections("GOOGLE_EARTH", projections))

    def test_kitti_frustum_crop_matches_jax(self):
        """A frustum that hangs off the map's low edges, so that the crop
        shifts, and the local projections and sky wall of that view."""
        projections = _kitti_projections()
        cam_pos, look_at = np.array([10.0, 3.0, 6.0]), np.array(
            [60.0, 40.0, 1.0])
        fov = jdg.helpers_intrinsic_fov("KITTI_360", 0) / 2
        cords = jdg.get_view_frustum_cords(cam_pos, look_at, 40, fov)
        _assert_same(dg.get_view_frustum_cords(cam_pos, look_at, 40, fov),
                     cords, "frustum")
        assert cords.min() < 0
        want = jdg.get_points_from_projections("KITTI_360", projections,
                                               cords)
        got = dg.get_points_from_projections("KITTI_360", projections, cords,
                                             device="cpu").numpy()
        _assert_same(got, want, "points")
        assert (want[:, 4] == 10005).any() and len(want) < len(
            jdg.get_points_from_projections("KITTI_360", projections))
        _assert_same(
            dg.get_local_projections(projections["REST"], cords, 32),
            jdg.get_local_projections(projections["REST"], cords, 32),
            "local projections")
        _assert_same(dg.get_sky_points(cords[1:3], 6.0, 0.3, 40, 4, 5),
                     jdg.get_sky_points(cords[1:3], 6.0, 0.3, 40, 4, 5),
                     "sky points")


class TestGenerateCity:
    @pytest.mark.parametrize("view", range(N_VIEWS))
    def test_generate_view_matches_jax(self, cities, view):
        """prj, vpm, msk, pts and the instance map of one view."""
        _, _, jviews, tviews = cities
        assert len(jviews) == len(tviews) == N_VIEWS
        (want, want_ins), (got, got_ins) = jviews[view], tviews[view]
        assert got.keys() == want.keys() == {"prj", "vpm", "msk", "pts"}
        _assert_same(got, want, f"view {view}")
        _assert_same(got_ins, want_ins, f"view {view} instance map")
        assert got["vpm"].shape == (540, 960)
        assert got["vpm"].max() == len(got["pts"]) - 1

    def test_generate_city_files_match_jax(self, cities):
        jroot, troot, _, _ = cities
        jcity, tcity = (os.path.join(r, "TestCity") for r in (jroot, troot))
        with open(os.path.join(jcity, "CENTERS.pkl"), "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(tcity, "CENTERS.pkl"), "rb") as f:
            got = pickle.load(f)
        _assert_same(got, want, "CENTERS.pkl")
        with open(os.path.join(tcity, "CameraPoses.csv")) as f:
            assert len(list(csv.DictReader(f))) == N_VIEWS
        for sub in ("Points", "InstanceImage"):
            names = sorted(os.listdir(os.path.join(jcity, sub)))
            assert names == sorted(os.listdir(os.path.join(tcity, sub)))
            assert len(names) == N_VIEWS
            for name in names:
                jpath, tpath = (os.path.join(c, sub, name)
                                for c in (jcity, tcity))
                if sub == "Points":
                    with open(jpath, "rb") as f:
                        want = pickle.load(f)
                    with open(tpath, "rb") as f:
                        got = pickle.load(f)
                    _assert_same(got, want, tpath)
                else:
                    with open(jpath, "rb") as f, open(tpath, "rb") as g:
                        assert f.read() == g.read(), tpath

    def test_dataset_items_match_jax(self, cities):
        """The port's GoogleEarthDataset on the port's city against the JAX
        dataset on the JAX city: the val split, item by item."""
        jroot, troot, _, _ = cities
        kw = dict(name="GOOGLE_EARTH", n_cities=1, n_views=N_VIEWS,
                  train_crop_size=(192, 96), test_crop_size=(192, 96),
                  train_min_pixels=1, proj_size=WINDOW, map_size=0, scale=1,
                  pin_memory=("Rt", "centers"))
        jcfg = JConfig(dataset=JDatasetConfig(dir=jroot, **kw),
                       train=JTrainConfig(max_points=4096))
        tcfg = Config(dataset=DatasetConfig(dir=troot, **kw),
                      train=TrainConfig(max_points=4096))
        want_ds = j_get_dataset(jcfg, "GOOGLE_EARTH", "val")
        got_ds = get_dataset(tcfg, "GOOGLE_EARTH", "val")
        assert len(got_ds) == len(want_ds) == 1
        want, got = want_ds[0], got_ds[0]
        _assert_same(got, want)
        assert got["proj_hf"].shape == (WINDOW, WINDOW, 1)
        assert got["pts_mask"].sum() > 0


class TestVisibleRaydirs:
    def test_get_visible_points_matches_jax(self, tmp_path, monkeypatch):
        """A small view off the axes, the reference corrected where the JAX
        march lands a corner-grazing ray off the DDA."""
        projections = synthetic_city(str(tmp_path))
        points = jdg.get_points_from_projections("GOOGLE_EARTH", projections)
        mins = points[:, :3].min(0)
        offsets = np.array([mins[0], mins[1], mins[2] - 1], np.int32)
        pos = np.array([12.0, 20.0, 30.0])
        quat = get_quat_from_look_at(pos, np.array([48.0, 52.0, 1.0]))
        s3 = np.repeat(points[:, 3:4], 3, axis=1).astype(np.int32)
        view = (60.0, (24.0, 40.0), (48, 80), VOL)
        monkeypatch.setattr(jvis, "visible_from_volume",
                            exact_visible_from_volume)
        want = jvis.get_visible_points(
            jnp.asarray(points), jnp.asarray(s3), jnp.asarray(pos,
                                                              jnp.float32),
            jnp.asarray(quat, jnp.float32), *view, jnp.asarray(offsets))
        tpts = torch.from_numpy(points)
        got = vis.get_visible_points(
            tpts, torch.from_numpy(s3), torch.tensor(pos, dtype=torch.float32),
            torch.tensor(quat, dtype=torch.float32), *view,
            torch.from_numpy(offsets))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert (got[0].numpy() >= 0).mean() > 0.5
        assert (got[1].numpy() >= 100).any()  # a building is in view

    def test_raydirs_match_jax(self):
        rng = np.random.default_rng(5)
        vol = (rng.random((16, 20, 12)) > 0.9).astype(np.int32)
        args = (np.float32([3.0, 4.0, 9.0]), np.float32([0.6, 0.7, -0.4]),
                np.float32([0.0, 0.0, 1.0]))
        cam = (12.0, (5.0, 7.5), (10, 15))
        want = _jax_raydirs_fn(*cam)(jnp.asarray(vol),
                                     *map(jnp.asarray, args))
        got = vis.ray_voxel_intersection(
            torch.from_numpy(vol), *map(torch.from_numpy, args), *cam)
        assert got.raydirs.shape == (10, 15, 3)
        assert got.raydirs.dtype == torch.float32
        np.testing.assert_allclose(got.raydirs.numpy(),
                                   np.asarray(want.raydirs), atol=1e-6)
        np.testing.assert_allclose(
            torch.linalg.norm(got.raydirs, dim=-1).numpy(), 1.0, atol=1e-6)


def test_generation_needs_a_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    projections = synthetic_city(str(tmp_path))
    pose = _poses()[0]
    args = ("GOOGLE_EARTH", projections, np.array([pose["tx"], pose["ty"],
                                                   pose["tz"]]),
            np.array([pose["qx"], pose["qy"], pose["qz"], pose["qw"]]))
    with pytest.raises(RuntimeError, match="CUDA"):
        dg.generate_view(*args, vol_shape=VOL)
    with pytest.raises(RuntimeError, match="CUDA"):
        dg.generate_city("GOOGLE_EARTH", str(tmp_path), [pose], VOL)
