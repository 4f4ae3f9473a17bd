# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: the LOCAL encoder's pieces, PTv3's
relative-position bias, the sorted-merge neighbour search and ``remat``.
Inputs are made with numpy from a seed; weights are carried from the Flax
trees by ``interop``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gaussiancity_tpu.config import PTv3Config as JPTv3Config
from gaussiancity_tpu.models import generator as jgen
from gaussiancity_tpu.models import ptv3 as jptv3

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.config import PTv3Config
from gaussiancity_tpu_torch.models import generator, ptv3
from gaussiancity_tpu_torch.testing import TINY_PTV3 as TINY, share_cpu_cores
from test_torch_ptv3 import _np_tree, _points, _port, _with_random_stats

share_cpu_cores()

# float32 convolutions, matmuls and sums in another order than XLA's
ATOL, RTOL = 1e-5, 1e-4


def _rel_close(got, want, rtol=RTOL, what=""):
    """Within ``rtol`` of the largest magnitude of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# ---------------------------------------------------------------------------
# LOCAL encoder
# ---------------------------------------------------------------------------


class TestLocalEncoder:
    def test_conv_transpose_matches_jax(self):
        """One ConvTranspose2d(4, 2, 1): the JAX layer's dilated,
        flipped-kernel correlation against ``conv_transpose2d`` on the
        transposed, unflipped weight; output and all three gradients
        within 1e-4 of the largest."""
        rng = np.random.default_rng(0)
        x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
        ct = rng.normal(size=(2, 10, 14, 4)).astype(np.float32)
        layer = jgen.TorchConvTranspose(4, (4, 4), (2, 2), (1, 1))
        params = _np_tree(layer.init(jax.random.PRNGKey(0),
                                     jnp.asarray(x)))["params"]

        def loss(p, xx):
            return jnp.sum(layer.apply({"params": p}, xx) * ct)

        want = layer.apply({"params": params}, jnp.asarray(x))
        g_p, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
        port = generator.TorchConvTranspose(6, 4, 4, 2, 1)
        port.load_state_dict({
            "weight": torch.from_numpy(
                np.asarray(params["kernel"]).transpose(2, 3, 0, 1)),
            "bias": torch.from_numpy(np.asarray(params["bias"]))})
        tx = torch.from_numpy(x).requires_grad_(True)
        got = port(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.shape == want.shape == (2, 10, 14, 4)
        _rel_close(got.detach(), want)
        (got * torch.from_numpy(ct)).sum().backward()
        _rel_close(tx.grad, g_x)
        _rel_close(port.weight.grad.permute(2, 3, 0, 1), g_p["kernel"])
        _rel_close(port.bias.grad, g_p["bias"])

    def test_grid_sample_uv_matches_jax_out_of_range(self):
        """Bilinear sampling at uv in and out of [-1, 1]: equal to the JAX
        function within 1e-6 everywhere; left of the map (uv < -1 -
        1/(W-1)) it mixes the first two columns, so it is not
        ``F.grid_sample``'s border mode there."""
        rng = np.random.default_rng(1)
        B, H, W, C, N = 2, 9, 12, 3, 400
        feat = rng.normal(size=(B, H, W, C)).astype(np.float32)
        uv = rng.uniform(-1.4, 1.4, (B, N, 2)).astype(np.float32)
        want = np.asarray(jgen.grid_sample_uv(jnp.asarray(feat),
                                              jnp.asarray(uv)))
        got = generator.grid_sample_uv(torch.from_numpy(feat),
                                       torch.from_numpy(uv)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        border = F.grid_sample(
            torch.from_numpy(feat).permute(0, 3, 1, 2),
            torch.from_numpy(uv)[:, :, None], padding_mode="border",
            align_corners=True)[..., 0].permute(0, 2, 1).numpy()
        inside = (np.abs(uv) <= 1).all(-1)
        far_left = uv[..., 0] < -1 - 2 / (W - 1)
        np.testing.assert_allclose(got[inside], border[inside], atol=1e-5)
        assert far_left.sum() > 10
        assert np.abs(got[far_left] - border[far_left]).max() > 1e-2

    def test_local_encoder_matches_jax(self):
        """The whole encoder on 32x32 maps: the [B, 32, 32, 2] map and the
        gradients of every weight and of both maps within 1e-4 of each
        one's largest."""
        rng = np.random.default_rng(2)
        hf = rng.uniform(0, 20, (2, 32, 32, 1)).astype(np.float32)
        seg = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (2, 32, 32))]
        ct = rng.normal(size=(2, 32, 32, 2)).astype(np.float32)
        enc = jgen.LocalEncoder(2)
        params = _np_tree(enc.init(jax.random.PRNGKey(2), jnp.asarray(hf),
                                   jnp.asarray(seg)))["params"]

        def loss(p, a, b):
            return jnp.sum(enc.apply({"params": p}, a, b) * ct)

        want = enc.apply({"params": params}, jnp.asarray(hf),
                         jnp.asarray(seg))
        g_p, g_hf, g_seg = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            params, jnp.asarray(hf), jnp.asarray(seg))
        port = generator.LocalEncoder(8, 2)
        state = {}
        interop._local_encoder(params, "enc", state)
        port.load_state_dict({k[4:]: v for k, v in state.items()})
        thf = torch.from_numpy(hf).requires_grad_(True)
        tseg = torch.from_numpy(seg).requires_grad_(True)
        got = port(thf, tseg)
        _rel_close(got.detach(), want)
        assert np.asarray(want).std() > 1e-3
        (got * torch.from_numpy(ct)).sum().backward()
        _rel_close(thf.grad, g_hf, what="hf")
        _rel_close(tseg.grad, g_seg, what="seg")
        want_g = {}
        interop._local_encoder(_np_tree(g_p), "enc", want_g)
        for name, p in port.named_parameters():
            _rel_close(p.grad, want_g["enc." + name], what=name)


# ---------------------------------------------------------------------------
# PTv3 options
# ---------------------------------------------------------------------------


def test_rpe_attention_matches_jax():
    """Patch attention with the relative-position bias, the last patch
    partial: the valid rows within 1e-5 + 1e-4 relative."""
    rng = np.random.default_rng(3)
    N, C, H, K, count = 96, 16, 4, 32, 77
    feat = rng.normal(size=(N, C)).astype(np.float32)
    grid = rng.integers(0, 12, (N, 3)).astype(np.int32)
    codes = np.where(np.arange(N) < count, rng.integers(0, 1000, N),
                     2 ** 31 - 1).astype(np.int32)
    order = np.argsort(codes, kind="stable").astype(np.int32)
    inverse = np.argsort(order).astype(np.int32)
    args = (jnp.asarray(feat), jnp.asarray(order), jnp.asarray(inverse),
            jnp.int32(count), jnp.asarray(grid))
    jattn = jptv3.PatchAttention(C, H, K, enable_rpe=True)
    variables = _np_tree(jattn.init(jax.random.PRNGKey(1), *args))
    # a table with spread, so that the bias matters
    variables["params"]["rpe_table"] = jnp.asarray(rng.normal(
        0, 0.5, variables["params"]["rpe_table"].shape), jnp.float32)
    want = np.asarray(jattn.apply(variables, *args))
    attn = _port(ptv3.PatchAttention(C, H, K, enable_rpe=True), variables)
    assert attn.rpe_table.shape == (3 * ptv3.rpe_bounds(K)[1], H)
    with torch.no_grad():
        got = attn(torch.from_numpy(feat), torch.from_numpy(order),
                   torch.from_numpy(inverse), count,
                   torch.from_numpy(grid)).numpy()
        plain = ptv3.PatchAttention(C, H, K)
        plain.load_state_dict({k: v for k, v in attn.state_dict().items()
                               if k != "rpe_table"})
        plain = plain(torch.from_numpy(feat), torch.from_numpy(order),
                      torch.from_numpy(inverse), count).numpy()
    valid = codes != 2 ** 31 - 1
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL,
                               rtol=RTOL)
    assert np.abs(got - plain).max() > 1e-2


@pytest.mark.parametrize("change", ["rpe", "sorted_merge"])
def test_ptv3_option_matches_jax(change):
    """The small PTv3 with ``enable_rpe`` or with the sorted-merge
    neighbour search (``dense_nbr_extent`` 0), eval mode with random
    running statistics, 150 valid points in a slab of 160: within 1e-5 +
    1e-4 relative.  The sorted search gives the dense search's output."""
    kw = (dict(enable_rpe=True) if change == "rpe"
          else dict(dense_nbr_extent=0))
    rng = np.random.default_rng(5)
    n, C = 150, 12
    coord, _ = _points(6, n)
    feat = rng.normal(size=(n, C)).astype(np.float32)
    jmodel = jptv3.PointTransformerV3(cfg=JPTv3Config(**TINY, **kw),
                                      in_channels=C)
    pfeat = np.concatenate([feat, np.zeros((10, C), np.float32)])
    pcoord = np.concatenate([coord, np.zeros((10, 3), np.float32)])
    valid = np.arange(160) < n
    args = (jnp.asarray(pfeat)[None], jnp.asarray(pcoord)[None],
            jnp.asarray(valid)[None])
    variables = _with_random_stats(
        jax.jit(jmodel.init)(jax.random.PRNGKey(7), *args), rng)
    want = np.asarray(jax.jit(jmodel.apply)(variables, *args))[0, :n]
    model = _port(ptv3.PointTransformerV3(PTv3Config(**TINY, **kw), C),
                  variables)
    with torch.no_grad():
        got = model(torch.from_numpy(feat)[None],
                    torch.from_numpy(coord)[None])[0].numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    if change == "sorted_merge":
        dense = _port(ptv3.PointTransformerV3(PTv3Config(**TINY), C),
                      variables)
        with torch.no_grad():
            np.testing.assert_array_equal(
                dense(torch.from_numpy(feat)[None],
                      torch.from_numpy(coord)[None])[0].numpy(), got)


class TestSortedMergeNeighbors:
    @pytest.mark.parametrize("k", [3, 5])
    def test_indices_equal_jax(self, k):
        """``nb_idx`` and ``found`` equal to the JAX merge's everywhere,
        invalid rows and co-voxel duplicates included (the lowest index
        wins), and to the dense search's where found."""
        rng = np.random.default_rng(10 + k)
        N = 700
        grid = rng.integers(0, 14, (N, 3)).astype(np.int32)
        grid[N // 2:N // 2 + 60] = grid[:60]  # co-voxel duplicates
        valid = rng.random(N) > 0.1
        nb_w, fnd_w = jptv3.subm_neighbors(jnp.asarray(grid),
                                           jnp.asarray(valid), k, 10)
        nb, fnd = ptv3.subm_neighbors(torch.from_numpy(grid),
                                      torch.from_numpy(valid), k, 10)
        assert nb.dtype == torch.int32 and fnd.dtype == torch.bool
        np.testing.assert_array_equal(fnd.numpy(), np.asarray(fnd_w))
        np.testing.assert_array_equal(nb.numpy(), np.asarray(nb_w))
        f = fnd.numpy()
        assert 0.05 < f.mean() < 0.95
        nb_d, fnd_d, _ = ptv3.subm_neighbors_dense(
            torch.from_numpy(grid), torch.from_numpy(valid), k, 16)
        np.testing.assert_array_equal(fnd_d.numpy(), f)
        np.testing.assert_array_equal(nb_d.numpy()[f], nb.numpy()[f])


def test_remat_changes_no_result():
    """``remat`` on against off, training mode with drop path 0.3 and the
    order shuffle on: the same drop-path and shuffle generator seeds give
    equal outputs, running statistics and gradients, to the bit."""
    cfg = PTv3Config(**{**TINY, "order": ("cord", "z")})
    rng = np.random.default_rng(12)
    feat = torch.from_numpy(rng.normal(size=(2, 120, 6)).astype(np.float32))
    coord = torch.from_numpy(
        rng.uniform(-0.2, 0.2, (2, 120, 3)).astype(np.float32))
    results = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = ptv3.PointTransformerV3(cfg.replace(remat=remat), 6,
                                        drop_path=0.3).train()
        x = feat.clone().requires_grad_(True)
        out = model(x, coord, None, torch.Generator().manual_seed(1),
                    torch.Generator().manual_seed(2))
        (out * out).sum().backward()
        results.append((out.detach(), x.grad,
                        {n: p.grad for n, p in model.named_parameters()},
                        {n: b.clone() for n, b in model.named_buffers()}))
    (o0, x0, g0, b0), (o1, x1, g1, b1) = results
    assert torch.equal(o0, o1) and torch.equal(x0, x1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    for name in b0:
        assert torch.equal(b0[name], b1[name]), name
