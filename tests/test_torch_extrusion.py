# -*- coding: utf-8 -*-
"""The port's footprint extrusion (``gaussiancity_tpu_torch/ops/
extrusion.py``) against the JAX package's: ``extrude_dense``, the padded
``extrude_points`` with its validity mask and overflow (``d_max`` below
and above the tallest column, ``n_max`` below and above the voxel count),
and the exact form (kernel E1's plain version on CPU tensors) against
both packages' NumPy mirrors; the port's g++ extruder against the NumPy
mirror.  Everything is held bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiancity_tpu.ops import extrusion as jext

from gaussiancity_tpu_torch.native import extrude_points_native
from gaussiancity_tpu_torch.ops import extrusion as ext
from gaussiancity_tpu_torch.testing import share_cpu_cores

from test_extrusion_visibility import make_maps

share_cpu_cores()


def _maps(seed, H=40, W=36):
    """Blocks of every class of the Google Earth table (the car sentinel
    32767 too) at random heights, some columns with TD < BU, and a random
    PTS mask."""
    rng = np.random.default_rng(seed)
    ins = np.ones((H, W), np.int32)
    td = np.full((H, W), 2, np.int32)
    bu = np.zeros((H, W), np.int32)
    for cls in (0, 3, 4, 5, 6, 32767, 100, 102, 104, 106):
        y, x = rng.integers(0, H - 4), rng.integers(0, W - 4)
        h, w = rng.integers(3, 12, 2)
        ins[y:y + h, x:x + w] = cls
        td[y:y + h, x:x + w] = rng.integers(0, 30)
        bu[y:y + h, x:x + w] = rng.integers(0, 4)
    low = rng.random((H, W)) < 0.05
    bu[low] = td[low] + rng.integers(1, 3, int(low.sum()))  # empty walks
    pts = rng.random((H, W)) > 0.2
    return ins, td, bu, pts


CASES = [("make_maps", 0), ("blocks", 0), ("blocks", 1)]


def _case(kind, seed):
    return make_maps(seed) if kind == "make_maps" else _maps(seed)


def _t(arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


REL = ext.SegInsRelation()
TABLE = ext.GOOGLE_EARTH_CLASS_SCALES


def test_tables_match_jax():
    assert ext.GOOGLE_EARTH_CLASS_SCALES == jext.GOOGLE_EARTH_CLASS_SCALES
    assert ext.KITTI_360_CLASS_SCALES == jext.KITTI_360_CLASS_SCALES
    assert tuple(ext.SegInsRelation()) == tuple(jext.SegInsRelation())
    ins = np.array([[0, 5, 99, 100, 101, 32766, 32767]], np.int32)
    np.testing.assert_array_equal(
        ext.semantic_ids(torch.as_tensor(ins), REL).numpy(),
        np.asarray(jext.semantic_ids(jnp.asarray(ins), jext.SegInsRelation())))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("include_btm", [True, False])
def test_exact_matches_numpy_mirrors(case, include_btm):
    maps = _case(*case)
    want = jext.extrude_points_np(*maps, jext.SegInsRelation(), TABLE,
                                  include_btm)
    np.testing.assert_array_equal(
        ext.extrude_points_np(*maps, REL, TABLE, include_btm), want)
    got = ext.extrude_points_exact(*_t(maps), REL, TABLE, include_btm)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("include_btm", [True, False])
def test_dense_matches_jax(case, include_btm):
    maps = _case(*case)
    want = jext.extrude_dense(*map(jnp.asarray, maps), jext.SegInsRelation(),
                              TABLE, 24, include_btm)
    got = ext.extrude_dense(*_t(maps), REL, TABLE, 24, include_btm)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("d_max,n_max", [(16, 8), (16, 4096), (40, 1500),
                                         (40, 8192)])
def test_padded_matches_jax_extrude_points(d_max, n_max):
    """``_maps(1)``'s tallest column reaches 29: d_max 16 cuts it, 40 does
    not; n_max 8 and 1500 overflow, the others do not."""
    maps = _maps(1)
    assert 16 < maps[1].max() < 40
    want = jext.extrude_points(*map(jnp.asarray, maps), jext.SegInsRelation(),
                               TABLE, d_max, n_max, False)
    got = ext.extrude_points(*_t(maps), REL, TABLE, d_max, n_max, False)
    for g, w, what in zip(got, want, ("points", "valid", "overflow")):
        assert g.shape == w.shape, what
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), what)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    if n_max in (8, 1500):
        assert int(got[2]) > 0
    else:
        assert int(got[2]) == 0 and int(got[1].sum()) < n_max


def test_edge_cases_match_numpy_mirror():
    """No masked pixel, a map of one row, a map narrower than the edge
    band, every walk empty (TD < BU), and the car sentinel: E1's plain
    version equals the NumPy mirror (an empty [0, 5] list included)."""
    ins, td, bu, pts = _maps(2)
    cases = [(ins, td, bu, np.zeros_like(pts)),
             (ins[:1], td[:1], bu[:1], pts[:1]),
             (ins[:3, :3], td[:3, :3], bu[:3, :3], pts[:3, :3]),
             (ins, td, td + 1, pts),
             (np.full_like(ins, 32767), td, bu, pts)]
    for maps in cases:
        want = jext.extrude_points_np(*maps, jext.SegInsRelation(), TABLE)
        got = ext.extrude_points_exact(*_t(maps), REL, TABLE)
        assert got.shape == want.shape == (len(want), 5)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("include_btm", [True, False])
def test_native_matches_numpy_mirror(include_btm):
    """The g++ extruder, on one thread and on eight, against the NumPy
    mirror and E1's plain version."""
    for maps in (_maps(0), _maps(3, H=128, W=96)):
        want = ext.extrude_points_np(*maps, REL, TABLE, include_btm)
        np.testing.assert_array_equal(
            ext.extrude_points_exact(*_t(maps), REL, TABLE,
                                     include_btm).numpy(), want)
        for n_threads in (1, 8):
            got = extrude_points_native(*maps, REL, TABLE, include_btm,
                                        n_threads=n_threads)
            np.testing.assert_array_equal(got, want)
