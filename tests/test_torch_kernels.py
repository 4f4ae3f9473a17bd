# -*- coding: utf-8 -*-
"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device (marker ``cuda``) and skips
without one.  The file imports no JAX, so that it runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py

The plain versions themselves are held to the JAX package by
test_torch_rasterizer.py and test_torch_visibility.py."""

import numpy as np
import pytest
import torch

from gaussiancity_tpu_torch.camera import CameraModel
from gaussiancity_tpu_torch.ops import visibility as vis
from gaussiancity_tpu_torch.ops.rasterizer import binning, blend, preprocess

pytestmark = pytest.mark.cuda

# -fmad=false and IEEE expf / division keep the kernels' rounding equal to
# the plain versions'; the tolerance leaves room for one ulp at the end
KERNEL_ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(seed, n, W, H, f, depth=(3.0, 60.0), scale=(0.05, 0.6)):
    rng = np.random.default_rng(seed)
    d = rng.uniform(*depth, n)
    arrays = [np.stack([d, rng.uniform(-1, 1, n) * d * W / (2 * f),
                        rng.uniform(-1, 1, n) * d * H / (2 * f)], -1),
              rng.uniform(0.1, 0.95, n), rng.uniform(*scale, (n, 3)),
              np.tile([1.0, 0.0, 0.0, 0.0], (n, 1)),
              rng.uniform(0, 1, (n, 3))]
    return [a.astype(np.float32) for a in arrays]


BLEND_CASES = {
    # n, (W, H), tile (h, w), capacity, gate, window (x0, y0, w, h)
    "tiles8x128": (3000, (256, 64), (8, 128), 256, False, None),
    "gate_window32": (3000, (256, 64), (32, 32), 256, True,
                      (92, 12, 128, 32)),
    "frame_truncated": (60000, (960, 540), (32, 32), 2048, True, None),
}


@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_blend_kernel_matches_plain(dev, case):
    n, (W, H), (th, tw), K, gate, window = BLEND_CASES[case]
    f = 0.8 * W
    Kmat = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    cam = CameraModel(Kmat, (W, H)).params(
        np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]), device=dev)
    means, op, sc, qu, co = (torch.from_numpy(a).to(dev)
                             for a in _scene(1, n, W, H, f))
    prep = preprocess.preprocess(means, op, sc, qu, co,
                                 torch.ones(n, dtype=torch.bool, device=dev),
                                 cam)
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
    args = (prep.attrs10(), bins.gauss_index, bins.counts, origin,
            torch.tensor([0.3, 0.1, 0.6], device=dev), H, W, consts)
    n0 = blend.blend_forward.launches
    got = blend.blend_forward(*args)
    assert blend.blend_forward.launches == n0 + 1
    want = blend.blend_forward_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], atol=KERNEL_ATOL, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=KERNEL_ATOL, rtol=0)
    assert (got[2] == want[2]).float().mean() >= 0.999
    assert int(want[2].max()) > 0
    if case == "frame_truncated":
        assert int(bins.n_truncated) > 0


def test_blend_kernel_rejects_mixed_devices(dev):
    consts = blend.BlendConsts(tile_h=8, tile_w=128, n_tx=2)
    attrs = torch.zeros(4, 10, device=dev)
    idx = torch.zeros(4, 16, dtype=torch.int32, device=dev)
    counts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        blend.blend_forward(attrs, idx, counts, (0, 0),
                            torch.zeros(3, device=dev), 32, 256, consts)


def _city_volume():
    rng = np.random.default_rng(21)
    vol = np.zeros((64, 64, 48), np.int32)
    occ = rng.random((64, 64, 12)) > 0.85
    vol[:, :, :12][occ] = rng.integers(1, 5000, occ.sum())
    vol[:, :, 0] = 9
    return vol


RAY_CASES = {
    # origin (y, x, z), view direction, f, (cy, cx), (H, W)
    "inside_slab": ([20.3, 7.7, 6.1], [0.3, 1.0, -0.1], 30.0, (24.0, 40.0),
                    (48, 80)),
    "sky_skip": ([32.2, 3.7, 40.4], [0.2, 1.0, -0.6], 40.0, (30.0, 50.0),
                 (60, 100)),
    "near_axis": ([32.0, 3.0, 30.0], [-1.7e-16, 0.72, -0.695], 40.0,
                  (30.0, 50.0), (60, 100)),
}


@pytest.mark.parametrize("case", sorted(RAY_CASES))
def test_raycast_kernel_matches_plain(dev, case):
    ori, vdir, f, c, hw = RAY_CASES[case]
    vol = torch.from_numpy(_city_volume()).to(dev)
    rays = vis.ray_basis(torch.tensor(ori, device=dev),
                         torch.tensor(vdir, device=dev),
                         torch.tensor([0.0, 0.0, 1.0], device=dev))
    ztop = vis.occupancy_top(vol)
    n0 = vis.raycast.launches
    got = vis.raycast(vol, rays, f, c, hw, ztop)
    assert vis.raycast.launches == n0 + 1
    want = vis.raycast_plain(vol, rays, f, c, hw, ztop)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    hit = want[0] != 0
    assert hit.float().mean() > 0.3
    torch.testing.assert_close(got[1][hit], want[1][hit], rtol=1e-5, atol=0)
    assert torch.isinf(got[1][~hit]).all()
