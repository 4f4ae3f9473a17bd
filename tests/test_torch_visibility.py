# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: footprint extrusion, the point-to-
volume scatter, the occupancy tables (``pack_occupancy``, bit for bit)
and the first-hit raycast (plain version vs the JAX march, on the scenes
of tests/test_extrusion_visibility.py), and the host helpers of the
inference frame.  The kernel-vs-plain checks are in
test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiancity_tpu.config import DatasetConfig as JDatasetConfig
from gaussiancity_tpu.data.datasets import (
    instances_to_classes_np as j_instances_to_classes_np)
from gaussiancity_tpu.data.transforms import (
    _normalize_rel_cords as j_normalize_rel_cords)
from gaussiancity_tpu.ops import extrusion as jext
from gaussiancity_tpu.ops import visibility as jvis
from gaussiancity_tpu.training.step import (
    instances_to_classes as j_instances_to_classes)
from gaussiancity_tpu.utils import helpers as jhelpers

from gaussiancity_tpu_torch.config import DatasetConfig
from gaussiancity_tpu_torch.data import dataset_generator as dg
from gaussiancity_tpu_torch.data.datasets import instances_to_classes_np
from gaussiancity_tpu_torch.data.transforms import _normalize_rel_cords
from gaussiancity_tpu_torch.ops import extrusion as ext
from gaussiancity_tpu_torch.ops import visibility as vis
from gaussiancity_tpu_torch.utils import helpers

from test_extrusion_visibility import numpy_dda


def make_maps(seed=0, H=24, W=24):
    """tests/test_extrusion_visibility.py make_maps, plus a second
    building and a car."""
    rng = np.random.default_rng(seed)
    ins = np.ones((H, W), np.int32)
    ins[6:14, 8:16] = 100
    ins[2:5, 18:22] = 103
    ins[18:, 18:] = 5
    ins[20:22, 2:4] = 32800
    td = np.full((H, W), 2, np.int32)
    td[6:14, 8:16] = 12
    td[2:5, 18:22] = 7
    bu = np.zeros((H, W), np.int32)
    pts = np.ones((H, W), bool)
    pts[::3, 1::2] = rng.random((len(range(0, H, 3)),
                                 len(range(1, W, 2)))) > 0.3
    return ins, td, bu, pts


class TestHostHelpers:
    @pytest.mark.parametrize("btm", [True, False])
    def test_extrusion_matches_jax(self, btm):
        maps = make_maps()
        for jrel, rel in ((jext.SegInsRelation(), ext.SegInsRelation()),
                          (jext.SegInsRelation(car_ins_min_id=32768,
                                               car_semantic_id=6),
                           ext.SegInsRelation(car_ins_min_id=32768,
                                              car_semantic_id=6))):
            for jtab, tab in ((jext.GOOGLE_EARTH_CLASS_SCALES,
                               dg.class_scale_table("GOOGLE_EARTH")),
                              (jext.KITTI_360_CLASS_SCALES,
                               dg.class_scale_table("KITTI_360"))):
                assert tab == jtab
                want = jext.extrude_points_np(*maps, jrel, jtab,
                                              include_btm_pts=btm)
                got = ext.extrude_points_np(*maps, rel, tab,
                                            include_btm_pts=btm)
                np.testing.assert_array_equal(got, want)

    def test_point_helpers_match_jax(self):
        rng = np.random.default_rng(2)
        n = 500
        inst = rng.choice([0, 1, 3, 5, 100, 101, 250, 16001, 32800],
                          (1, n)).astype(np.int32)
        kw = dict(bldg_range=(100, 16384), facade_clsid=2, roof_clsid=7,
                  car_range=(16384, 65536), car_clsid=3)
        classes = helpers.instances_to_classes(torch.from_numpy(inst), **kw)
        np.testing.assert_array_equal(
            classes.numpy(),
            np.asarray(j_instances_to_classes(jnp.asarray(inst), **kw)))
        jds = JDatasetConfig(car_range=(16384, 65536), car_clsid=3)
        ds = DatasetConfig(car_range=(16384, 65536), car_clsid=3)
        np.testing.assert_array_equal(
            instances_to_classes_np(inst[0], ds),
            j_instances_to_classes_np(inst[0], jds))
        cls = np.clip(classes.numpy(), 0, 7)
        np.testing.assert_array_equal(
            helpers.get_one_hot(torch.from_numpy(cls), 8).numpy(),
            np.asarray(jhelpers.get_one_hot(jnp.asarray(cls), 8)))
        scales = rng.uniform(0.5, 4, (1, n, 1)).astype(np.float32)
        np.testing.assert_array_equal(
            helpers.get_point_scales(torch.from_numpy(scales),
                                     torch.from_numpy(cls), (1, 5)).numpy(),
            np.asarray(jhelpers.get_point_scales(
                jnp.asarray(scales), jnp.asarray(cls), (1, 5))))
        xyz = rng.uniform(0, 64, (1, n, 3)).astype(np.float32)
        tlp = np.float32([[3.0, 5.0]])
        for t in (None, tlp):
            np.testing.assert_allclose(
                helpers.get_projection_uv(
                    torch.from_numpy(xyz),
                    None if t is None else torch.from_numpy(t), 64).numpy(),
                np.asarray(jhelpers.get_projection_uv(
                    jnp.asarray(xyz), None if t is None else jnp.asarray(t),
                    64)), atol=1e-6)
        attrs = {"rgb": rng.normal(size=(1, n, 3)).astype(np.float32),
                 "xyz": rng.normal(size=(1, n, 3)).astype(np.float32),
                 "scale": rng.random((1, n, 3)).astype(np.float32)}
        s3 = np.repeat(scales, 3, -1)
        np.testing.assert_allclose(
            helpers.get_gaussian_points(
                torch.from_numpy(xyz), torch.from_numpy(s3),
                {k: torch.from_numpy(v) for k, v in attrs.items()}).numpy(),
            np.asarray(jhelpers.get_gaussian_points(
                jnp.asarray(xyz), jnp.asarray(s3),
                {k: jnp.asarray(v) for k, v in attrs.items()})), atol=1e-6)
        assert helpers.MAX_N_INSTANCES == jhelpers.MAX_N_INSTANCES

    def test_normalize_rel_cords_matches_jax(self):
        rng = np.random.default_rng(4)
        pts = np.concatenate([rng.integers(0, 64, (300, 3)),
                              rng.integers(1, 4, (300, 1)),
                              rng.choice([1, 2, 100, 101, 104], (300, 1))],
                             1).astype(np.int32)
        centers = {100: (10.0, 12.0, 8.0, 6.0, 20.0),
                   101: (10.0, 12.0, 8.0, 6.0, 20.0),
                   104: (40.0, 30.0, 0.0, 5.0, 0.0)}
        np.testing.assert_array_equal(_normalize_rel_cords(pts, centers),
                                      j_normalize_rel_cords(pts, centers))


class TestVolume:
    def test_box_fill(self):
        vol = vis.points_to_volume(
            torch.tensor([[2, 3, 1], [0, 0, 0]], dtype=torch.int32),
            torch.tensor([7, 9], dtype=torch.int32),
            torch.tensor([[2, 2, 2], [1, 1, 1]], dtype=torch.int32),
            8, 8, 8).numpy()
        assert vol[3, 2, 1] == 7 and vol[4, 3, 2] == 7
        assert vol[5, 2, 1] == 0
        assert vol[0, 0, 0] == 9
        assert vol.sum() == 7 * 8 + 9

    def test_matches_jax_with_overlaps(self):
        rng = np.random.default_rng(21)
        n = 400
        pts = rng.integers(-2, 21, (n, 3)).astype(np.int32)
        ids = rng.permutation(np.arange(1, n + 1)).astype(np.int32)
        sc = rng.integers(1, 5, (n, 1)).repeat(3, 1).astype(np.int32)
        sc[::3, 2] = 1
        sc[::7] = 3  # (3, 3) and (3, 1): both groups
        sc[::11, 0] = 6  # outside the groups: left out by both
        valid = rng.random(n) > 0.1
        want = np.asarray(jvis.points_to_volume(
            jnp.asarray(pts), jnp.asarray(ids), jnp.asarray(sc), 22, 21, 23,
            valid=jnp.asarray(valid)))
        got = vis.points_to_volume(
            torch.from_numpy(pts), torch.from_numpy(ids),
            torch.from_numpy(sc), 22, 21, 23,
            valid=torch.from_numpy(valid)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (want > 0).sum() > 1000
        assert vis.pack_occupancy(torch.from_numpy(want.copy())).ztop == (
            float(np.nonzero((want != 0).any((0, 1)))[0].max() + 1))


def _random_volume():
    rng = np.random.default_rng(3)
    vol = np.zeros((16, 16, 16), np.int32)
    occ = rng.random((16, 16, 16)) > 0.93
    vol[occ] = rng.integers(1, 100, occ.sum())
    return (vol, [2.3, 7.7, 8.1], [1.0, 0.1, -0.2], 10.0, (6.0, 8.0),
            (12, 16))


def _wall():
    vol = np.zeros((16, 32, 16), np.int32)
    vol[:, 20, :] = 5
    return vol, [8.0, 2.0, 8.0], [0.0, 1.0, 0.0], 20.0, (4.0, 4.0), (8, 8)


def _sky_skip():
    rng = np.random.default_rng(7)
    vol = np.zeros((24, 24, 40), np.int32)
    occ = rng.random((24, 24, 6)) > 0.7
    vol[:, :, :6][occ] = rng.integers(1, 50, occ.sum())
    return (vol, [12.2, 11.7, 35.4], [0.4, 0.3, -1.0], 4.0, (5.0, 7.0),
            (10, 14))


def _city_floor():
    """A ground layer and scattered columns seen from high up at a slant:
    long sky skips, grazing rays and far hits."""
    rng = np.random.default_rng(21)
    vol = np.zeros((40, 40, 48), np.int32)
    occ = rng.random((40, 40, 8)) > 0.9
    vol[:, :, :8][occ] = rng.integers(1, 50, occ.sum())
    vol[:, :, 0] = 9
    return (vol, [20.2, 3.7, 30.4], [0.2, 1.0, -0.35], 6.0, (8.0, 10.0),
            (16, 20))


RAY_SCENES = {"random": _random_volume, "wall": _wall,
              "sky_skip": _sky_skip, "city_floor": _city_floor}


def _rays_args(scene):
    vol, ori, cam_dir, f, c, hw = scene
    return (vol, np.float32(ori), np.float32(cam_dir),
            np.float32([0, 0, 1]), f, c, hw)


def _occ_volume(shape, density, seed):
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.int32)
    occ = rng.random(shape) < density
    vol[occ] = rng.integers(1, 1000, occ.sum())
    return vol


OCC_VOLUMES = {
    # shape, share of occupied voxels: d a multiple of 32 and not, h and
    # w multiples of 16 and not, and an empty volume
    "d64_hw_aligned": ((32, 48, 64), 0.05),
    "d40_hw_ragged": ((37, 21, 40), 0.08),
    "d7_dense": ((18, 50, 7), 0.3),
    "empty_d33": ((20, 19, 33), 0.0),
}


class TestOccupancy:
    @pytest.mark.parametrize("name", sorted(OCC_VOLUMES))
    def test_pack_occupancy_matches_jax(self, name):
        shape, density = OCC_VOLUMES[name]
        vol = _occ_volume(shape, density, seed=len(name))
        occ_words, ztop, coarse, coarse2 = jvis.pack_occupancy(
            jnp.asarray(vol))
        got = vis.pack_occupancy(torch.from_numpy(vol))
        for ours, theirs in ((got.occ_words, occ_words),
                             (got.coarse_cols, coarse),
                             (got.coarse2_cols, coarse2)):
            assert ours.dtype == torch.uint32
            theirs = np.asarray(theirs)
            assert theirs.dtype == np.uint32
            np.testing.assert_array_equal(ours.numpy(), theirs)
        assert got.ztop == float(ztop)
        layers = np.nonzero((vol != 0).any((0, 1)))[0]
        assert got.ztop == (float(layers.max() + 1) if layers.size else 0.0)
        if density == 0:
            assert got.ztop == 0.0 and int(got.coarse2_cols.numpy().max()) == 0

    @pytest.mark.parametrize("name", sorted(RAY_SCENES))
    def test_raycast_with_and_without_tables(self, name):
        """The wrapper and ray_voxel_intersection give the plain version's
        ids and depths whether the caller passes the tables or not."""
        vol, ori, cd, up, f, c, hw = _rays_args(RAY_SCENES[name]())
        tv = torch.from_numpy(vol)
        occ = vis.pack_occupancy(tv)
        rays = vis.ray_basis(torch.from_numpy(ori), torch.from_numpy(cd),
                             torch.from_numpy(up))
        want = vis.raycast_plain(tv, rays, f, c, hw, occ.ztop)
        assert (want[0] != 0).any()
        for tables in (None, occ):
            got = vis.raycast(tv, rays, f, c, hw, tables)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            res = vis.ray_voxel_intersection(
                tv, torch.from_numpy(ori), torch.from_numpy(cd),
                torch.from_numpy(up), f, c, hw, occupancy=tables)
            assert torch.equal(res.voxel_id, want[0])
            assert torch.equal(res.depth, want[1])
        # the diagnostic variant: the plain version steps every cell
        ids, depth, work = vis.raycast_work(tv, rays, f, c, hw, occ)
        assert torch.equal(ids, want[0]) and torch.equal(depth, want[1])
        assert torch.equal(work[..., 0], want[2]) and not work[..., 1].any()

    def test_raycast_rejects_foreign_tables(self):
        vol = torch.zeros((8, 8, 40), dtype=torch.int32)
        other = vis.pack_occupancy(torch.zeros((8, 8, 8), dtype=torch.int32))
        rays = vis.ray_basis(torch.tensor([4.0, 4.0, 4.0]),
                             torch.tensor([1.0, 0.0, 0.0]),
                             torch.tensor([0.0, 0.0, 1.0]))
        with pytest.raises(ValueError):
            vis.raycast(vol, rays, 2.0, (1.0, 1.0), (2, 2), other)


class TestRaycast:
    @pytest.mark.parametrize("name", sorted(RAY_SCENES))
    def test_plain_matches_jax(self, name):
        vol, ori, cd, up, f, c, hw = _rays_args(RAY_SCENES[name]())
        want = jvis.ray_voxel_intersection(
            jnp.asarray(vol), jnp.asarray(ori), jnp.asarray(cd),
            jnp.asarray(up), f, c, hw)
        got = vis.ray_voxel_intersection(
            torch.from_numpy(vol), torch.from_numpy(ori),
            torch.from_numpy(cd), torch.from_numpy(up), f, c, hw)
        wid = np.asarray(want.voxel_id)
        np.testing.assert_array_equal(got.voxel_id.numpy(), wid)
        hit = wid != 0
        assert hit.any()
        np.testing.assert_allclose(got.depth.numpy()[hit],
                                   np.asarray(want.depth)[hit], rtol=1e-5)
        assert np.isinf(got.depth.numpy()[~hit]).all()
        if name == "wall":
            assert (wid == 5).all()
        if name == "sky_skip":
            assert (~hit).any()  # upward rays miss

    def test_near_axis_rays(self):
        """A view whose direction has a ~1e-16 component along a volume
        axis (an orbit pose at 180 degrees).  The port hits what the JAX
        suite's scalar DDA hits; the JAX march misses the pixel column
        whose rays keep that component, so it is held to the scalar DDA
        here and not to the march."""
        vol = np.zeros((40, 40, 24), np.int32)
        vol[:, :, :3] = np.arange(1, 1 + 40 * 40 * 3).reshape(40, 40, 3)
        ori = np.float32([20.0, 3.0, 20.0])
        vdir = np.float32([-1.7e-16, 0.72, -0.695])
        up = np.float32([0, 0, 1])
        H, W, f, c = 16, 24, 20.0, (8.0, 12.0)
        got = vis.ray_voxel_intersection(
            torch.from_numpy(vol), torch.from_numpy(ori),
            torch.from_numpy(vdir), torch.from_numpy(up), f, c, (H, W))
        want = jvis.ray_voxel_intersection(
            jnp.asarray(vol), jnp.asarray(ori), jnp.asarray(vdir),
            jnp.asarray(up), f, c, (H, W))
        rds = np.asarray(want.raydirs)
        ids = got.voxel_id.numpy()
        for py in range(H):
            for px in range(W):
                want_id, want_t = numpy_dda(vol, ori, rds[py, px])
                assert ids[py, px] == want_id, (py, px)
                np.testing.assert_allclose(got.depth[py, px], want_t,
                                           rtol=1e-5)
        assert (ids[:, int(c[1])] != 0).sum() > H // 2
        off = np.arange(W) != int(c[1])
        np.testing.assert_array_equal(ids[:, off],
                                      np.asarray(want.voxel_id)[:, off])

    def test_wrapper_checks_inputs(self):
        vol = torch.zeros((4, 4, 4), dtype=torch.int32)
        rays = torch.zeros(12)
        with pytest.raises(TypeError):
            vis.raycast(vol.long(), rays, 1.0, (1.0, 1.0), (2, 2))
        with pytest.raises(TypeError):
            vis.raycast(vol, rays[:9], 1.0, (1.0, 1.0), (2, 2))
        with pytest.raises(ValueError):
            vis.raycast(vol.permute(2, 1, 0), rays, 1.0, (1.0, 1.0),
                        (2, 2))
