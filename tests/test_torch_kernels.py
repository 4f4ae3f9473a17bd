# -*- coding: utf-8 -*-
"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device (marker ``cuda``) and skips
without one.  The file imports no JAX, so that it runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py

The plain versions themselves are held to the JAX package by
test_torch_rasterizer.py (K1, K2 and the per-Gaussian use of K3),
test_torch_models.py (the hash-grid use of K3 and G1's plain version),
test_torch_segment_sum.py (K3's module) and test_torch_visibility.py (V1
and its occupancy tables).  K4 is the JAX package's gather probe
and has no JAX counterpart on the CPU.  G1b's plain version is held to
the JAX custom VJP by test_torch_models.py, E1's (the footprint
extrusion) to the JAX extruders by test_torch_extrusion.py."""

import numpy as np
import pytest
import torch

from gaussiancity_tpu_torch import _kernels
from gaussiancity_tpu_torch.camera import CameraModel
from gaussiancity_tpu_torch.ops import gather_rowsum as gr
from gaussiancity_tpu_torch.ops import hash_grid, hash_grid_bwd
from gaussiancity_tpu_torch.ops import visibility as vis
from gaussiancity_tpu_torch.ops.rasterizer import binning, blend, preprocess
from gaussiancity_tpu_torch.testing import share_cpu_cores

share_cpu_cores()

pytestmark = pytest.mark.cuda

# -fmad=false and IEEE expf / division keep the kernels' rounding equal to
# the plain versions'; the tolerance leaves room for one ulp at the end
KERNEL_ATOL = 1e-5
# K2's per-pixel terms equal the plain version's; its sums over a tile's
# pixels run in another order (warp shuffles, then warps in order, against
# torch's reduction): tolerance relative to each gradient column's
# largest magnitude
K2_RTOL = 1e-4
# K3 sums each run in sorted order, index_add_ in its own: relative to the
# largest output magnitude
K3_RTOL = 1e-5
# G1's per-corner terms equal the plain version's, only the order of the
# corner sum differs; K4 widens bf16 exactly and sums 8 channels in
# another order: relative to the largest output
G1_RTOL = 1e-6
# G1b: keys, weights and each corner's term equal the plain version's; the
# sums over channels, 2^D corners and L levels run in another order:
# relative to the largest input gradient
G1B_RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(seed, n, W, H, f, layout="uniform"):
    """Seeded Gaussians over the view: "uniform" (scales 0.05-0.6),
    "small" (scales 0.005-0.03: gate rects of one or two 16x16 blocks) or
    "heavy" (as uniform, plus n more in a small patch of the view: one
    tile holds far more slots than the rest)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-1, 1, (n, 2))
    scale = (0.005, 0.03) if layout == "small" else (0.05, 0.6)
    if layout == "heavy":
        u = np.concatenate([u, rng.uniform(0.1, 0.2, (n, 2))])
        n = 2 * n
    d = rng.uniform(3.0, 60.0, n)
    arrays = [np.stack([d, u[:, 0] * d * W / (2 * f),
                        u[:, 1] * d * H / (2 * f)], -1),
              rng.uniform(0.1, 0.95, n), rng.uniform(*scale, (n, 3)),
              np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
              rng.uniform(0, 1, (n, 3))]
    return [a.astype(np.float32) for a in arrays]


def _binned(case, cases, seed, dev):
    """A case's scene, preprocessed and binned as ``rasterize`` does:
    (attrs, bins, origin, H, W, consts)."""
    n, (W, H), (th, tw), K, gate, window, layout = cases[case]
    f = 0.8 * W
    Kmat = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    cam = CameraModel(Kmat, (W, H)).params(
        np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]), device=dev)
    means, op, sc, qu, co = (torch.from_numpy(a).to(dev)
                             for a in _scene(seed, n, W, H, f, layout))
    prep = preprocess.preprocess(means, op, sc, qu, co,
                                 torch.ones(means.shape[0], dtype=torch.bool,
                                            device=dev), cam)
    origin = (0.0, 0.0)
    bin_prep = prep
    if window is not None:
        x0, y0, W, H = window
        origin = (float(x0), float(y0))
        bin_prep = prep._replace(mx=prep.mx - x0, my=prep.my - y0)
    bins = binning.bin_gaussians(bin_prep, H, W, th, tw, K, gate16=gate,
                                 gate_origin=origin if window else None)
    _, n_tx = binning.tile_grid(H, W, th, tw)
    consts = blend.BlendConsts(tile_h=th, tile_w=tw, n_tx=n_tx,
                               ref_gate=gate)
    counts = bins.counts.float()
    if layout == "heavy":
        assert float(counts.max()) > 3 * float(counts.median())
    return prep.attrs10(), bins, origin, H, W, consts


BLEND_CASES = {
    # n, (W, H), tile (h, w), capacity, gate, window (x0, y0, w, h),
    # scene layout
    "tiles8x128": (3000, (256, 64), (8, 128), 256, False, None, "uniform"),
    "gate_window32": (3000, (256, 64), (32, 32), 256, True,
                      (92, 12, 128, 32), "uniform"),
    "frame_truncated": (60000, (960, 540), (32, 32), 2048, True, None,
                        "uniform"),
    # most slots of a 32x32 tile fail the gate in three of its four
    # 16x16 blocks
    "crowded_small32": (30000, (256, 128), (32, 32), 1024, True, None,
                        "small"),
    "one_heavy_tile": (3000, (256, 64), (32, 32), 4096, True, None,
                       "heavy"),
    "tiles16": (3000, (256, 64), (16, 16), 256, True, None, "uniform"),
    "window_odd8x128": (3000, (256, 64), (8, 128), 256, True,
                        (37, 21, 160, 40), "uniform"),
    # one sample of the B = 2 BLDG step: its 640x448 crop of the 960x540
    # sensor at the BLDG recipe's tiles and capacity
    "bldg_crop640x448": (16384, (960, 540), (32, 32), 1024, True,
                         (160, 46, 640, 448), "uniform"),
}


@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_blend_kernel_matches_plain(dev, case):
    attrs, bins, origin, H, W, consts = _binned(case, BLEND_CASES, 1, dev)
    args = (attrs, bins.gauss_index, bins.counts, origin,
            torch.tensor([0.3, 0.1, 0.6], device=dev), H, W, consts)
    n0 = blend.blend_forward.launches
    got = blend.blend_forward(*args)
    assert blend.blend_forward.launches == n0 + 1
    want = blend.blend_forward_plain(*args)
    torch.cuda.synchronize()
    # the design keeps the plain version's per-pixel arithmetic and order:
    # bit-equal
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    assert int(want[2].max()) > 0
    if case == "frame_truncated":
        assert int(bins.n_truncated) > 0


def test_blend_kernel_queued_launches_with_empty_tiles(dev):
    """Tiles with no slot and tiles with one among full ones (the
    persistent blocks take the most slots first, then 0 and 1 in any
    order): a queue of back-to-back launches ends, each bit-equal to the
    plain version.  An empty tile's unit must stage nothing: a batch that
    is never waited for leaves a persistent block's barrier parity two
    phases behind its next wait, and the queue hangs."""
    import time

    attrs, bins, origin, H, W, consts = _binned("frame_truncated",
                                                BLEND_CASES, 1, dev)
    pick = torch.randint(0, 4, bins.counts.shape,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    counts = torch.where(pick == 0, 0, torch.where(
        pick == 1, bins.counts.clamp(max=1), bins.counts)).to(torch.int32)
    assert int((counts == 0).sum()) > 50 and int((counts == 1).sum()) > 50
    args = (attrs, bins.gauss_index, counts, origin,
            torch.tensor([0.3, 0.1, 0.6], device=dev), H, W, consts)
    want = blend.blend_forward_plain(*args)
    outs = [blend.blend_forward(*args) for _ in range(32)]
    done = torch.cuda.Event()
    done.record()
    t0 = time.monotonic()
    while not done.query():
        assert time.monotonic() - t0 < 60, "queued K1 launches did not end"
        time.sleep(0.01)
    for got in outs:
        assert all(torch.equal(a, b) for a, b in zip(got, want[:3]))


def test_blend_kernel_rejects_mixed_devices(dev):
    consts = blend.BlendConsts(tile_h=8, tile_w=128, n_tx=2)
    attrs = torch.zeros(4, 10, device=dev)
    idx = torch.zeros(4, 16, dtype=torch.int32, device=dev)
    counts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        blend.blend_forward(attrs, idx, counts, (0, 0),
                            torch.zeros(3, device=dev), 32, 256, consts)


K2_CASES = {
    # n, (W, H), tile (h, w), capacity, gate, window (x0, y0, w, h),
    # scene layout
    "tiles8x128": (3000, (256, 64), (8, 128), 256, False, None, "uniform"),
    "gate_window32": (3000, (256, 64), (32, 32), 256, True,
                      (92, 12, 128, 32), "uniform"),
    "edge_tiles": (20000, (960, 540), (32, 32), 1024, True, None,
                   "uniform"),
    "bldg_crop640x448": (16384, (960, 540), (32, 32), 1024, True,
                         (160, 46, 640, 448), "uniform"),
    "crowded_small32": (30000, (256, 128), (32, 32), 1024, True, None,
                        "small"),
    "one_heavy_tile": (3000, (256, 64), (32, 32), 4096, True, None,
                       "heavy"),
    "tiles16": (3000, (256, 64), (16, 16), 256, True, None, "uniform"),
    "window_odd8x128": (3000, (256, 64), (8, 128), 256, True,
                        (37, 21, 160, 40), "uniform"),
}


def _blend_bwd_into(out, attrs, gauss_index, k_hi, origin, g_out, bg_dot_g,
                    final_T, n_contrib, consts):
    """K2 launched as ``blend.blend_backward`` launches it, into ``out``
    [T * K, 9] float32 instead of a new buffer."""
    T, K = gauss_index.shape
    img_h, img_w = final_T.shape
    scratch = torch.empty(2 * T, dtype=torch.int32, device=out.device)
    _kernels.launch(
        "blend_bwd", blend._kernel_attrs(attrs).data_ptr(),
        gauss_index.data_ptr(), k_hi.data_ptr(), T, K, consts.n_tx,
        consts.tile_h, consts.tile_w,
        *blend.sub_tile_shape(consts.tile_h, consts.tile_w), img_h, img_w,
        float(origin[0]), float(origin[1]), int(consts.ref_gate),
        consts.alpha_min, consts.alpha_max, g_out.data_ptr(),
        bg_dot_g.data_ptr(), final_T.data_ptr(), n_contrib.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), _kernels.stream_handle(out.device))
    return out


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_blend_backward_kernel_matches_plain(dev, case):
    attrs, bins, origin, H, W, consts = _binned(case, K2_CASES, 2, dev)
    th, K = consts.tile_h, bins.gauss_index.shape[1]
    T = bins.gauss_index.shape[0]
    bg = torch.tensor([0.3, 0.1, 0.6], device=dev)
    _, final_T, n_contrib = blend.blend_forward(
        attrs, bins.gauss_index, bins.counts, origin, bg, H, W, consts)
    k_hi = blend.tile_k_hi(bins.counts, n_contrib, consts)
    gen = torch.Generator(device=dev).manual_seed(3)
    g_out = torch.randn((3, H, W), generator=gen, device=dev)
    bg_dot_g = torch.randn((H, W), generator=gen, device=dev)
    args = (attrs, bins.gauss_index, k_hi, origin, g_out, bg_dot_g, final_T,
            n_contrib, consts)
    # rows exist only for k < k_hi: the first sum(k_hi) rows, compact; the
    # kernel leaves every other row of its output as it was
    n = int(k_hi.long().sum())
    n0 = blend.blend_backward.launches
    got = blend.blend_backward(*args)
    again = blend.blend_backward(*args)
    assert blend.blend_backward.launches == n0 + 2
    nan = _blend_bwd_into(torch.full((T * K, 9), float("nan"), device=dev),
                          *args)
    want = blend.blend_backward_plain(*args)
    torch.cuda.synchronize()
    assert 0 < n < T * K
    assert torch.isnan(nan[n:]).all() and torch.equal(nan[:n], got[:n])
    assert torch.equal(got[:n], again[:n])  # no atomics
    scale = want[:n].abs().amax(dim=0)
    assert (scale > 0).all()
    assert ((got[:n] - want[:n]).abs() <= K2_RTOL * scale).all()
    if case == "edge_tiles":
        assert H % th != 0


def test_segment_sum_kernel_matches_index_add(dev):
    rng = np.random.default_rng(4)
    L, M, C, R = 4, 50000, 8, 3000
    keys = rng.integers(0, R + 200, (L, M))  # duplicates and keys >= R
    keys[1] = R + 5  # a level whose keys all fall outside the table
    keys[2, :M // 2] = 17  # one long run
    keys = np.sort(keys, axis=1).astype(np.int32)
    rows = rng.normal(size=(L, M, C)).astype(np.float32)
    tk, tr = torch.from_numpy(keys).to(dev), torch.from_numpy(rows).to(dev)
    n0 = hash_grid_bwd.segment_sum_sorted.launches
    got = hash_grid_bwd.segment_sum_sorted(tk, tr, R)
    again = hash_grid_bwd.segment_sum_sorted(tk, tr, R)
    assert hash_grid_bwd.segment_sum_sorted.launches == n0 + 2
    want = hash_grid_bwd.segment_sum_sorted_plain(tk, tr, R)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # no atomics: bit-equal repeat
    assert (got[1] == 0).all()
    untouched = torch.ones((L, R), dtype=torch.bool, device=dev)
    for lvl in range(L):
        k = tk[lvl].long()
        untouched[lvl, k[k < R]] = False
    assert untouched.any() and (got[untouched] == 0).all()
    assert ((got - want).abs() <= K3_RTOL * want.abs().max()).all()


def _k3_keys(rng, layout, L, M, R):
    """Sorted int32 keys [L, M] of one layout."""
    if layout == "short_runs":  # runs of a few rows, many across chunk edges
        keys = rng.integers(0, R, (L, M))
    elif layout == "one_long_run":  # one key over 20,000 rows: many chunks
        keys = rng.integers(0, R, (L, M))
        keys[:, M // 2 - 10000:M // 2 + 10000] = R // 3
    elif layout == "all_outside":  # every key < 0 or >= R
        keys = np.where(rng.random((L, M)) < 0.5,
                        rng.integers(-50, 0, (L, M)),
                        rng.integers(R, R + 50, (L, M)))
    elif layout == "with_outside":  # negative keys and keys >= R as well
        keys = rng.integers(-R // 4, R + R // 4, (L, M))
    elif layout == "per_gaussian":  # kept slots, then the key R of drops
        keys = rng.integers(0, R, (L, M))
        keys[:, M // 4:] = R
    else:
        raise ValueError(layout)
    return np.sort(keys, axis=1).astype(np.int32)


K3_CASES = {
    # L, M, C, R, key layout.  The kernel's chunk is 128, 256 or 512
    # sorted rows, the largest that still gives the card's SMs 8 blocks
    # each: the first cases run 128-row chunks, "l16_c8_chunk512" and
    # "long_run_chunk256" the larger ones (on a 132-SM card).
    "cross_edges_c8": (1, 5000, 8, 1200, "short_runs"),
    "m_ragged_c16": (3, 1077, 16, 900, "short_runs"),
    "one_long_run_c9": (1, 20000, 9, 3000, "one_long_run"),
    "all_outside_c8": (2, 3000, 8, 500, "all_outside"),
    "with_outside_c1_l16": (16, 4099, 1, 2000, "with_outside"),
    "r_far_above_m_c9": (1, 3000, 9, 200000, "short_runs"),
    "r_far_below_m_c8": (2, 60000, 8, 40, "short_runs"),
    "per_gaussian_tail_c9": (1, 65536, 9, 16384, "per_gaussian"),
    "l16_c8_chunk512": (16, 40000, 8, 30000, "short_runs"),
    "long_run_chunk256_c9": (1, 300000, 9, 50000, "one_long_run"),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_segment_sum_kernel_cases(dev, case):
    L, M, C, R, layout = K3_CASES[case]
    rng = np.random.default_rng(len(case))
    keys = _k3_keys(rng, layout, L, M, R)
    rows = rng.normal(size=(L, M, C)).astype(np.float32)
    tk, tr = torch.from_numpy(keys).to(dev), torch.from_numpy(rows).to(dev)
    n0 = hash_grid_bwd.segment_sum_sorted.launches
    got = hash_grid_bwd.segment_sum_sorted(tk, tr, R)
    again = hash_grid_bwd.segment_sum_sorted(tk, tr, R)
    assert hash_grid_bwd.segment_sum_sorted.launches == n0 + 2
    want = hash_grid_bwd.segment_sum_sorted_plain(tk, tr, R)
    torch.cuda.synchronize()
    assert got.shape == (L, R, C)
    assert torch.equal(got, again)  # no atomics: bit-equal repeat
    named = np.zeros((L, R), bool)
    for lvl in range(L):
        k = keys[lvl]
        named[lvl, k[(k >= 0) & (k < R)]] = True
    named = torch.from_numpy(named).to(dev)
    assert (got[~named] == 0).all()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= K3_RTOL * scale
    if layout == "all_outside":
        assert scale == 0 and not named.any()
    else:
        assert scale > 0


def test_segment_sum_callers_match_cpu(dev):
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, 700, 20000))
    rows = torch.from_numpy(rng.normal(size=(20000, 9)).astype(np.float32))
    got = hash_grid_bwd.reduce_rows(keys.to(dev), rows.to(dev), 600)
    want = hash_grid_bwd.reduce_rows(keys, rows, 600)
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=K3_RTOL * float(want.abs().max()))
    L, NC, N, C, R = 3, 32, 2000, 8, 4096
    idx = torch.from_numpy(rng.integers(0, R, (L, NC, N)))
    w = torch.from_numpy(rng.random((L, NC, N)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(L, N, C)).astype(np.float32))
    got = hash_grid_bwd.hash_grad_embeddings(idx.to(dev), w.to(dev),
                                             g.to(dev), R)
    want = hash_grid_bwd.hash_grad_embeddings(idx, w, g, R)
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=K3_RTOL * float(want.abs().max()))


def _city_volume():
    rng = np.random.default_rng(21)
    vol = np.zeros((64, 64, 48), np.int32)
    occ = rng.random((64, 64, 12)) > 0.85
    vol[:, :, :12][occ] = rng.integers(1, 5000, occ.sum())
    vol[:, :, 0] = 9
    return vol


def _ragged_volume():
    """h, w and d not multiples of 16 or 32: a ground layer, scattered
    columns and a solid 16x16-aligned block with a hollow inside."""
    rng = np.random.default_rng(22)
    vol = np.zeros((53, 71, 45), np.int32)
    occ = rng.random((53, 71, 14)) > 0.92
    vol[:, :, :14][occ] = rng.integers(1, 5000, occ.sum())
    vol[:, :, 0] = 7
    vol[16:32, 16:32, 10:20] = np.arange(1, 16 * 16 * 10 + 1).reshape(
        16, 16, 10)
    vol[22:27, 22:27, 12:18] = 0
    return vol


def _wide_volume():
    """A city floor of 1040 x 1040 columns (0.83 GB of ids): its 16x16
    table (65 x 65 blocks x 6 z-words, 101,400 B) is over the kernel's
    96 KB of shared memory, so V1 reads it from global memory."""
    rng = np.random.default_rng(23)
    vol = np.zeros((1040, 1040, 192), np.int32)
    occ = rng.random((1040, 1040, 10)) > 0.995
    vol[:, :, 1:11][occ] = rng.integers(1, 2 ** 30, occ.sum())
    vol[:, :, 0] = 11
    vol[500:700, 300:340, :60] = 12  # a block standing out of the floor
    return vol


RAY_SCENES = {"city": _city_volume, "ragged": _ragged_volume,
              "wide": _wide_volume}

RAY_CASES = {
    # origin (y, x, z), view direction, f, (cy, cx), (H, W), volume
    "inside_slab": ([20.3, 7.7, 6.1], [0.3, 1.0, -0.1], 30.0, (24.0, 40.0),
                    (48, 80), "city"),
    "sky_skip": ([32.2, 3.7, 40.4], [0.2, 1.0, -0.6], 40.0, (30.0, 50.0),
                 (60, 100), "city"),
    "near_axis": ([32.0, 3.0, 30.0], [-1.7e-16, 0.72, -0.695], 40.0,
                  (30.0, 50.0), (60, 100), "city"),
    # a volume whose h, w, d are not multiples of 16 or 32, seen from a
    # slant above
    "ragged_volume": ([5.5, 3.2, 40.7], [0.6, 1.0, -0.7], 35.0,
                      (27.0, 45.0), (57, 93), "ragged"),
    # the camera in the hollow of the solid 16x16 block
    "camera_in_block": ([24.5, 24.2, 15.5], [1.0, 0.3, -0.2], 25.0,
                        (20.0, 30.0), (41, 63), "ragged"),
    # rays along the 16- and 4-cell block edges (integer origin, axis
    # views): crossings tie on block boundaries
    "grazing_block_edges": ([16.0, 4.0, 30.0], [0.0, 1.0, -0.5], 16.0,
                            (8.0, 8.0), (17, 17), "ragged"),
    # long slanted rays over hundreds of 16x16 blocks of a table that does
    # not fit in shared memory
    "global_table": ([40.3, 60.7, 150.2], [1.0, 0.8, -0.25], 60.0,
                     (40.0, 64.0), (80, 128), "wide"),
}


@pytest.mark.parametrize("case", sorted(RAY_CASES))
def test_raycast_kernel_matches_plain(dev, case):
    ori, vdir, f, c, hw, scene = RAY_CASES[case]
    vol_np = RAY_SCENES[scene]()
    vol = torch.from_numpy(vol_np).to(dev)
    rays = vis.ray_basis(torch.tensor(ori, device=dev),
                         torch.tensor(vdir, device=dev),
                         torch.tensor([0.0, 0.0, 1.0], device=dev))
    occ = vis.pack_occupancy(vol)
    in_smem = occ.coarse2_cols.numel() * 4 <= 96 * 1024
    assert in_smem == (scene != "wide")
    n0 = vis.raycast.launches
    got = vis.raycast(vol, rays, f, c, hw, occ)
    built = vis.raycast(vol, rays, f, c, hw)  # tables built inside
    counted = vis.raycast_work(vol, rays, f, c, hw, occ)
    assert vis.raycast.launches == n0 + 3
    want = vis.raycast_plain(vol, rays, f, c, hw, occ.ztop)
    torch.cuda.synchronize()
    for res in (got, built, counted):
        assert torch.equal(res[0], want[0])
        assert torch.equal(res[1], want[1])  # bit-equal, inf on a miss
    # the kernel steps through at most the cells the walk steps through
    work = counted[2]
    assert (work[..., 0] <= want[2]).all() and (work[..., 0] > 0).any()
    if scene == "wide":  # the rays cross many empty blocks
        assert int(work[..., 1].sum()) > hw[0] * hw[1]
    hit = want[0] != 0
    assert hit.float().mean() > 0.3
    assert torch.isinf(got[1][~hit]).all()
    if not in_smem:
        return
    # the tables on the card equal the CPU's
    cpu = vis.pack_occupancy(torch.from_numpy(vol_np))
    for name in ("occ_words", "coarse_cols", "coarse2_cols"):
        assert np.array_equal(getattr(occ, name).cpu().numpy(),
                              getattr(cpu, name).numpy())


G1_CASES = {
    # D, L, base res, desired res, log2 rows, C, N: dense and hashed
    # levels, N not a multiple of the 256-thread block
    "xyz_dense_and_hashed_c2": (3, 4, 4, 64, 8, 2, 3001),
    "rest_5d_c8": (5, 16, 16, 512, 19, 8, 20000),
    "rest_5d_c8_small_table": (5, 3, 16, 64, 10, 8, 777),
    # the REST grid (every level hashed, 2^19 rows) at one point more than
    # the train step's: N is not a multiple of the 32-point block
    "rest_5d_c8_all_hashed_ragged": (5, 16, 16, 512, 19, 8, 16385),
}


@pytest.mark.parametrize("case", sorted(G1_CASES))
def test_hash_encode_kernel_matches_plain(dev, case):
    D, L, base, desired, log2, C, N = G1_CASES[case]
    _, _, _, hashed, _ = hash_grid.level_params(D, L, base, desired, log2)
    if case.startswith("xyz"):
        assert not hashed[0] and hashed[-1]
    if "all_hashed" in case:
        assert all(hashed) and N % 32
    shape = hash_grid.table_shape(D, L, base, desired, log2, C)
    rng = np.random.default_rng(6)
    emb = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    # a few points outside [-1, 1] give zeros
    x = torch.from_numpy(rng.uniform(-1.05, 1.05, (N, D)).astype(np.float32))
    args = (x.to(dev), emb.to(dev), L, base, desired, log2)
    n0 = hash_grid.hash_encode_fwd.launches
    got = hash_grid.hash_encode_fwd(*args)
    again = hash_grid.hash_encode_fwd(*args)
    assert hash_grid.hash_encode_fwd.launches == n0 + 2
    want = hash_grid.hash_encode_fwd_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    scale = float(want.abs().max())
    assert scale > 0.1
    assert float((got - want).abs().max()) <= G1_RTOL * scale
    oob = (x.abs() > 1).any(-1).to(dev)
    assert oob.any() and (got[oob] == 0).all()
    # the CPU plain version gives the same
    torch.testing.assert_close(got.cpu(), hash_grid.hash_encode_fwd_plain(
        x, emb, L, base, desired, log2), rtol=0, atol=G1_RTOL * scale)


def test_hash_encode_kernel_rejects_mixed_devices(dev):
    with pytest.raises(ValueError):
        hash_grid.hash_encode_fwd(torch.zeros((4, 3), device=dev),
                                  torch.zeros((2, 64, 2)), 2, 4, 16, 6)


G1B_CASES = {
    # D, L, base res, desired res, log2 rows, C, N
    "xyz_dense_and_hashed_c2": (3, 4, 4, 64, 8, 2, 3001),
    "rest_5d_c8_all_hashed_ragged": (5, 16, 16, 512, 19, 8, 16385),
}


@pytest.mark.parametrize("need_inputs", [True, False],
                         ids=["with_dx", "without_dx"])
@pytest.mark.parametrize("case", sorted(G1B_CASES))
def test_hash_encode_bwd_kernel_matches_plain(dev, case, need_inputs):
    D, L, base, desired, log2, C, N = G1B_CASES[case]
    shape = hash_grid.table_shape(D, L, base, desired, log2, C)
    rng = np.random.default_rng(8)
    emb = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1.05, 1.05, (N, D)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(N, L * C)).astype(np.float32))
    args = (x.to(dev), emb.to(dev), g.to(dev), L, base, desired, log2)
    n0 = hash_grid.hash_encode_bwd.launches
    got = hash_grid.hash_encode_bwd(*args, need_inputs=need_inputs)
    again = hash_grid.hash_encode_bwd(*args, need_inputs=need_inputs)
    assert hash_grid.hash_encode_bwd.launches == n0 + 2
    want = hash_grid.hash_encode_bwd_plain(*args, need_inputs=need_inputs)
    torch.cuda.synchronize()
    # keys, weights and the masked per-level gradient: bit-equal
    for a, b, c in zip(got[:3], again[:3], want[:3]):
        assert torch.equal(a, c) and torch.equal(a, b)
    oob = (x.abs() > 1).any(-1).to(dev)
    assert oob.any() and (got[2][:, oob] == 0).all()
    if not need_inputs:
        assert got[3] is None and want[3] is None
        return
    assert torch.equal(got[3], again[3])
    scale = float(want[3].abs().max())
    assert scale > 0.1
    assert float((got[3] - want[3]).abs().max()) <= G1B_RTOL * scale
    assert (got[3][oob] == 0).all()
    # the input gradient alone writes no keys
    only_dx = hash_grid.hash_encode_bwd(*args, need_embeddings=False)
    assert only_dx[:3] == (None, None, None)
    assert torch.equal(only_dx[3], got[3])


def test_hash_encode_backward_through_autograd(dev):
    """hash_encode's gradients on the card (G1b, then K3) against the CPU
    (the plain versions)."""
    D, L, base, desired, log2, C, N = 5, 4, 16, 64, 12, 8, 3001
    shape = hash_grid.table_shape(D, L, base, desired, log2, C)
    rng = np.random.default_rng(9)
    emb = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    x = torch.from_numpy(rng.uniform(-1.05, 1.05, (N, D)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(N, L * C)).astype(np.float32))
    grads = {}
    for where in (dev, torch.device("cpu")):
        tx = x.to(where).requires_grad_(True)
        te = emb.to(where).requires_grad_(True)
        (hash_grid.hash_encode(tx, te, D, L, base, desired, log2)
         * g.to(where)).sum().backward()
        grads[where.type] = (tx.grad.cpu(), te.grad.cpu())
    for got, want, rtol in zip(grads["cuda"], grads["cpu"],
                               (G1B_RTOL, K3_RTOL)):
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= rtol * scale


def test_gather_rowsum_kernel_matches_plain(dev):
    table, idx = gr.probe_inputs(seed=3, device=dev)
    idx[0, :5] = torch.tensor([-3, 0, gr.PROBE_ROWS - 1, gr.PROBE_ROWS,
                               2 ** 30], device=dev)  # clamped
    n0 = gr.gather_rowsum.launches
    got = gr.gather_rowsum(table, idx)
    again = gr.gather_rowsum(table, idx)
    assert gr.gather_rowsum.launches == n0 + 2
    want = gr.gather_rowsum_plain(table, idx)
    torch.cuda.synchronize()
    assert got.shape == idx.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert float(want.abs().max()) > 1
    # bf16 -> float32 is exact and both add the 8 channels in order
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["ragged", "unaligned"])
def test_gather_rowsum_kernel_ragged(dev, case):
    """An index count that is not a multiple of 4 (the last thread's
    tail), and an index pointer off 16 bytes (scalar loads)."""
    table, idx = gr.probe_inputs(seed=4, device=dev)
    idx = idx.reshape(-1)
    if case == "ragged":
        idx = idx[:7 * 1001].reshape(7, 1001)
    else:
        idx = idx[1:4002]
    assert idx.numel() % 4 and (case == "ragged") == (idx.data_ptr() % 16 == 0)
    n0 = gr.gather_rowsum.launches
    got = gr.gather_rowsum(table, idx)
    assert gr.gather_rowsum.launches == n0 + 1
    want = gr.gather_rowsum_plain(table, idx)
    torch.cuda.synchronize()
    assert got.shape == idx.shape
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the LOCAL step's hash-grid inputs and the B = 2 BLDG step
# ---------------------------------------------------------------------------


def _local_points(N, seed):
    """Hash-grid inputs as the LOCAL REST step makes them: two encoder
    dimensions that vary from point to point (a tanh feature map sampled
    at each point's uv) before rel_xyz, where the GLOBAL step's are one
    constant per scene."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-1, 1, (N, 2))
    enc = np.tanh(np.stack([2 * np.sin(3 * uv[:, 0]),
                            2 * np.cos(5 * uv[:, 1]) * uv[:, 0]], -1))
    rel = rng.uniform(-1.02, 1.02, (N, 3))
    return np.concatenate([enc, rel], -1).astype(np.float32)


@pytest.mark.parametrize("N", [16384, 3001])
def test_hash_grid_kernels_on_local_inputs(dev, N):
    """G1, G1b with the input gradient, and G1b then K3 through autograd,
    on the LOCAL step's inputs at the REST recipe's grid (16 levels of 8
    channels up to 2048, 2^19 rows): each against its plain version."""
    D, L, base, desired, log2, C = 5, 16, 16, 2048, 19, 8
    shape = hash_grid.table_shape(D, L, base, desired, log2, C)
    rng = np.random.default_rng(11)
    emb = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
    x = torch.from_numpy(_local_points(N, 12))
    g = torch.from_numpy(rng.normal(size=(N, L * C)).astype(np.float32))
    args = (x.to(dev), emb.to(dev), L, base, desired, log2)
    got = hash_grid.hash_encode_fwd(*args)
    want = hash_grid.hash_encode_fwd_plain(*args)
    bargs = (x.to(dev), emb.to(dev), g.to(dev), L, base, desired, log2)
    got_b = hash_grid.hash_encode_bwd(*bargs)
    want_b = hash_grid.hash_encode_bwd_plain(*bargs)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert scale > 0.1
    assert float((got - want).abs().max()) <= G1_RTOL * scale
    for a, b in zip(got_b[:3], want_b[:3]):
        assert torch.equal(a, b)
    scale = float(want_b[3].abs().max())
    assert scale > 0 and float(want_b[3][:, :2].abs().max()) > 0
    assert float((got_b[3] - want_b[3]).abs().max()) <= G1B_RTOL * scale
    grads = {}
    for where in (dev, torch.device("cpu")):
        tx = x.to(where).requires_grad_(True)
        te = emb.to(where).requires_grad_(True)
        (hash_grid.hash_encode(tx, te, D, L, base, desired, log2)
         * g.to(where)).sum().backward()
        grads[where.type] = (tx.grad.cpu(), te.grad.cpu())
    for got_g, want_g, rtol in zip(grads["cuda"], grads["cpu"],
                                   (G1B_RTOL, K3_RTOL)):
        scale = float(want_g.abs().max())
        assert scale > 0
        assert float((got_g - want_g).abs().max()) <= rtol * scale


def test_bldg_batch2_step_card_matches_cpu(dev, monkeypatch):
    """Two steps of a tiny BLDG config at batch size 2 (two samples, the
    second with a quarter of its rows masked; drop path off; one z table
    on both devices, whose generators draw differently): the card
    (K1, K2 and K3 per Gaussian for each sample) against the CPU (plain
    versions), losses within 1e-4 relative, gradients within 1e-3 of
    each tensor's largest or 1e-5 of the model's largest gradient,
    whichever is more: float32 sums over the points in other orders err
    by ~eps x the sum of the terms' magnitudes, which for a gradient that
    nearly cancels (the LayerNorm before the attention, the key bias,
    whose gradient is 0 in exact arithmetic) exceeds 1e-3 of the
    tensor's own largest (measured on the card: 7e-7 of the model's
    largest).  TF32 is off, as ``chip_smoke.py`` sets it: cuDNN's default
    TF32 convolutions in D and VGG would err by ~1e-3 alone."""
    from gaussiancity_tpu_torch.config import (
        Config, DatasetConfig, DiscriminatorOptim, GaussianNetworkConfig,
        PTv3Config, RasterizerConfig, TrainConfig)
    from gaussiancity_tpu_torch.models import ptv3
    from gaussiancity_tpu_torch.testing import TINY_PTV3, tiny_bldg_batch
    from gaussiancity_tpu_torch.training.step import Trainer
    from gaussiancity_tpu_torch.utils import helpers

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    table = torch.randn((helpers.MAX_N_INSTANCES, 16),
                        generator=torch.Generator().manual_seed(7))
    monkeypatch.setattr(helpers, "get_z", lambda gen, ins, z_dim: table.to(
        ins.device)[ins.long() % table.shape[0]])
    cfg = Config(
        dataset=DatasetConfig(
            sensor_size=(256, 64), train_crop_size=(128, 32), n_classes=8,
            proj_size=32, cam_k=(100.0, 0, 128.0, 0, 100.0, 32.0, 0, 0, 1)),
        network=GaussianNetworkConfig(
            scale_factor=0.65, encoder=None, encoder_out_dim=3,
            pos_emd="SIN_COS", sin_cos_freq_bends=4, z_dim=16,
            mlp_hidden_dim=32, dis_n_channel_base=8,
            ptv3=PTv3Config(**TINY_PTV3)),
        rasterizer=RasterizerConfig(tile_h=8, tile_w=128, tile_capacity=128),
        train=TrainConfig(
            batch_size=2, allow_random_vgg=True,
            perceptual_loss_layers=("relu_1_1", "relu_2_1"),
            perceptual_loss_weights=(0.5, 1.0),
            discriminator=DiscriminatorOptim(n_warmup_iters=1)))
    one, two = tiny_bldg_batch(cfg, 256, seed=4), tiny_bldg_batch(
        cfg, 256, seed=5)
    batch = {k: np.concatenate([one[k], two[k]]) for k in one}
    batch["pts_mask"][1, 192:] = False
    batch["cam_pos"][1] = [0.0, 0.5, 0.0]
    runs = {}
    for where in (dev, torch.device("cpu")):
        t = Trainer(cfg, device=where, seed=3)
        ptv3.no_drop_path(t.generator)
        tb = {k: torch.as_tensor(v, device=where) for k, v in batch.items()}
        out = []
        for _ in range(2):
            m = {k: float(v) for k, v in t.train_step(tb).items()}
            out.append((m, {n: p.grad.detach().cpu().clone() for mod in
                            (t.generator, t.discriminator)
                            for n, p in mod.named_parameters()}))
        runs[where.type] = out
    for (m_card, g_card), (m_cpu, g_cpu) in zip(runs["cuda"], runs["cpu"]):
        for k, v in m_cpu.items():
            assert abs(m_card[k] - v) <= 1e-4 * abs(v) + 1e-7, (k, m_card[k],
                                                                 v)
        top = max(float(g.abs().max()) for g in g_cpu.values())
        for name, want in g_cpu.items():
            tol = max(1e-3 * float(want.abs().max()), 1e-5 * top)
            err = float((g_card[name] - want).abs().max())
            assert err <= tol, (name, err, tol, top)


# ---------------------------------------------------------------------------
# E1: footprint extrusion
# ---------------------------------------------------------------------------


def _extrusion_maps(seed, H, W):
    """Blocks of every Google Earth class (the car sentinel 32767 too) at
    random heights on roads, some walks empty (TD < BU), a random PTS."""
    rng = np.random.default_rng(seed)
    ins = np.ones((H, W), np.int32)
    td = np.full((H, W), 2, np.int32)
    bu = np.zeros((H, W), np.int32)
    for k in range(max(8, H * W // 400)):
        cls = [0, 3, 4, 5, 6, 32767, 100 + 2 * k][k % 7]
        y, x = rng.integers(0, max(1, H - 4)), rng.integers(0, max(1, W - 4))
        h, w = rng.integers(2, 14, 2)
        ins[y:y + h, x:x + w] = cls
        td[y:y + h, x:x + w] = rng.integers(0, 60)
        bu[y:y + h, x:x + w] = rng.integers(0, 5)
    low = rng.random((H, W)) < 0.05
    bu[low] = td[low] + rng.integers(1, 4, int(low.sum()))
    pts = rng.random((H, W)) > 0.25
    return ins, td, bu, pts


EXTRUDE_CASES = {
    "blocks": (0, 96, 80),
    "wide": (1, 33, 517),  # rows not a multiple of the block, odd width
    "thin": (2, 3, 64),  # every pixel inside the forced edge band
    "one_pixel": (3, 1, 1),
}


@pytest.mark.parametrize("case", sorted(EXTRUDE_CASES))
@pytest.mark.parametrize("include_btm", [True, False])
def test_extrude_kernel_matches_plain(dev, case, include_btm):
    """E1's rows bit-equal to the plain version's (order included), on a
    repeat too, and one launch counted a call."""
    from gaussiancity_tpu_torch.ops import extrusion as ext

    maps = [torch.as_tensor(a, device=dev)
            for a in _extrusion_maps(*EXTRUDE_CASES[case])]
    args = (*maps, ext.SegInsRelation(), ext.GOOGLE_EARTH_CLASS_SCALES,
            include_btm)
    n0 = ext.extrude_rows.launches
    got = ext.extrude_points_exact(*args)
    again = ext.extrude_points_exact(*args)
    assert ext.extrude_rows.launches == n0 + 2
    want, n = ext.extrude_rows_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert int(n) == len(want)
    assert torch.equal(got, want) and torch.equal(got, again)


def test_extrude_kernel_floor_division_and_empty(dev):
    """Columns with TD < BU emit nothing (C's truncating division would
    give them one voxel); no masked pixel, and no rows at all, give an
    empty [0, 5] list; int16 maps as the PNGs load are widened alike."""
    from gaussiancity_tpu_torch.ops import extrusion as ext

    ins, td, bu, pts = _extrusion_maps(4, 40, 40)
    rel, table = ext.SegInsRelation(), ext.GOOGLE_EARTH_CLASS_SCALES
    for maps in ((ins, td, td + 1, pts), (ins, td, td + 3, pts),
                 (ins, td, bu, np.zeros_like(pts)),
                 (ins.astype(np.int16), td.astype(np.int16),
                  bu.astype(np.int16), pts.astype(np.int16))):
        t = [torch.as_tensor(a, device=dev) for a in maps]
        t[3] = t[3] != 0
        got = ext.extrude_points_exact(*t, rel, table)
        want, _ = ext.extrude_rows_plain(*[a.cpu() for a in t], rel, table)
        assert got.shape == want.shape == (len(want), 5)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("types", [
    ("int16", "int16", "int16", "bool"),  # the PNG maps as uploaded
    ("int16", "int16", "int16", "uint8"),
    ("int32", "int32", "int32", "int16"),  # a PTS converted first
    ("int16", "int32", "int16", "bool"),  # mixed maps widened to int32
])
def test_extrude_kernel_map_types(dev, types):
    """E1 reads int16 and int32 maps and a bool or uint8 PTS as given,
    and converts other types first: the rows equal the plain version's
    on the int32 maps."""
    from gaussiancity_tpu_torch.ops import extrusion as ext

    maps = _extrusion_maps(6, 48, 56)
    rel, table = ext.SegInsRelation(), ext.GOOGLE_EARTH_CLASS_SCALES
    got = ext.extrude_points_exact(
        *[torch.as_tensor(a.astype(t), device=dev)
          for a, t in zip(maps, types)], rel, table)
    want, _ = ext.extrude_rows_plain(*[torch.as_tensor(a) for a in maps],
                                     rel, table)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("d_max,n_max", [(16, 64), (16, 1 << 16),
                                         (80, 5000), (80, 1 << 16)])
def test_extrude_kernel_z_cap_and_capacity(dev, d_max, n_max):
    """The padded form: the z cap (d_max below and above the tallest
    column, 57), the first n_max rows, the zero padding, the validity
    mask and the overflow equal the plain version's."""
    from gaussiancity_tpu_torch.ops import extrusion as ext

    maps = _extrusion_maps(5, 64, 72)
    args = (ext.SegInsRelation(), ext.GOOGLE_EARTH_CLASS_SCALES, d_max,
            n_max, False)
    got = ext.extrude_points(*[torch.as_tensor(a, device=dev)
                               for a in maps], *args)
    want = ext.extrude_points(*[torch.as_tensor(a) for a in maps], *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    assert (int(want[2]) > 0) == (n_max < 1 << 16)
