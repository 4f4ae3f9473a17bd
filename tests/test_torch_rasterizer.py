# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: camera, preprocess, binning, the blend
forward (plain version vs the Pallas kernel in interpret mode and vs the
XLA scan) and ``rasterize`` end to end.  Inputs are made with numpy from
a seed and fed to both packages.  The kernel-vs-plain checks are in
test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiancity_tpu.camera import CameraModel as JCameraModel
from gaussiancity_tpu.config import RasterizerConfig as JRasterizerConfig
from gaussiancity_tpu.ops.rasterizer import binning as jbinning
from gaussiancity_tpu.ops.rasterizer import blend as jblend
from gaussiancity_tpu.ops.rasterizer import blend_pallas
from gaussiancity_tpu.ops.rasterizer import preprocess as jpreprocess
from gaussiancity_tpu.ops.rasterizer import rasterize as jrasterize

from gaussiancity_tpu_torch.camera import CameraModel
from gaussiancity_tpu_torch.config import RasterizerConfig
from gaussiancity_tpu_torch.ops.rasterizer import binning, blend, preprocess
from gaussiancity_tpu_torch.ops.rasterizer import rasterize
from gaussiancity_tpu_torch.testing import share_cpu_cores

share_cpu_cores()

# the JAX suite's tolerance between its own two blend backends
# (tests/test_blend_pallas.py:32)
BLEND_ATOL = 1e-6


def np_camera(W=256, H=64, f=100.0):
    """Camera at the origin looking along +x (tests/test_rasterizer.py
    make_camera), for both packages."""
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float64)
    pose = (np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0]))
    return (JCameraModel(K, (W, H)).params(*pose),
            CameraModel(K, (W, H)).params(*pose, device="cpu"))


def np_scene(seed, n=256, depth_range=(4.0, 40.0), opacity_max=0.9):
    """tests/test_rasterizer.py make_scene, drawn with numpy."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(*depth_range, n)
    y = rng.uniform(-1.2, 1.2, n) * depth
    z = rng.uniform(-0.4, 0.4, n) * depth
    means = np.stack([depth, y, z], -1)
    scales = rng.uniform(0.05, 0.6, (n, 3))
    quats = np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
    colors = rng.uniform(0.0, 1.0, (n, 3))
    opacity = rng.uniform(0.1, opacity_max, n)
    return tuple(a.astype(np.float32)
                 for a in (means, opacity, scales, quats, colors))


def stacked_scene(n=64, opacity=0.9, seed=4):
    """Identical means: every depth ties, pixels saturate."""
    rng = np.random.default_rng(seed)
    return (np.tile(np.float32([10.0, 0.0, 0.0]), (n, 1)),
            np.full(n, opacity, np.float32), np.full((n, 3), 0.5, np.float32),
            np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def crowded_scene(n=256, seed=5):
    """Many Gaussians per tile: truncates at a small tile_capacity
    (tests/test_blend_pallas.py test_truncated_tiles_match)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(8, 30, n), rng.uniform(-1, 1, n),
                      rng.uniform(-0.2, 0.2, n)], -1)
    return (means.astype(np.float32), np.full(n, 0.4, np.float32),
            np.full((n, 3), 0.3, np.float32),
            np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def jax_args(scene):
    return [jnp.asarray(a) for a in scene]


def torch_args(scene):
    return [torch.from_numpy(np.array(a)) for a in scene]


class TestCameraAndPreprocess:
    def test_camera_matrices(self):
        rng = np.random.default_rng(0)
        K = np.array([[90.0, 0, 60], [0, 95.0, 40], [0, 0, 1]])
        jm, tm = JCameraModel(K, (128, 80)), CameraModel(K, (128, 80))
        for _ in range(4):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            pos = rng.normal(size=3) * 10
            j, t = jm.params(pos, q), tm.params(pos, q, device="cpu")
            for name in ("view_matrix", "full_proj", "cam_pos"):
                np.testing.assert_allclose(
                    getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                    atol=1e-5, rtol=1e-5, err_msg=name)
            for name in ("tan_fovx", "tan_fovy", "focal_x", "focal_y"):
                assert getattr(t, name) == getattr(j, name)
            jt = jm.params_traced(jnp.asarray(pos, jnp.float32),
                                  jnp.asarray(q, jnp.float32))
            tt = tm.params_f32(torch.tensor(pos, dtype=torch.float32),
                               torch.tensor(q, dtype=torch.float32))
            for name in ("view_matrix", "full_proj", "cam_pos"):
                np.testing.assert_allclose(
                    getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                    atol=1e-5, rtol=1e-5, err_msg=name)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_preprocess_every_field(self, seed):
        jcam, tcam = np_camera()
        scene = np_scene(seed, n=512, depth_range=(0.1, 40.0))
        valid = np.random.default_rng(seed).random(512) > 0.1
        j = jpreprocess.preprocess(*jax_args(scene), jnp.asarray(valid),
                                   jcam)
        t = preprocess.preprocess(*torch_args(scene), torch.tensor(valid),
                                  tcam)
        for name in j._fields:
            a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
            if name in ("radius", "valid"):
                np.testing.assert_array_equal(b, a, err_msg=name)
            else:
                np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5,
                                           err_msg=name)
        assert t.radius.dtype == torch.int32 and (~t.valid).any()


BIN_CASES = {
    # scene, tiles (h, w), capacity, ref gate, window
    "plain": (lambda: np_scene(0, n=512), (8, 128), 512, False, None),
    "gate_window": (lambda: np_scene(3, n=512), (32, 32), 512, True,
                    (92, 12, 128, 32)),
    "depth_ties": (lambda: stacked_scene(), (8, 128), 128, True, None),
    "truncated": (lambda: crowded_scene(), (8, 128), 16, False, None),
}


class TestBinning:
    @pytest.mark.parametrize("case", sorted(BIN_CASES))
    def test_slot_lists_match(self, case):
        make, (th, tw), K, gate, window = BIN_CASES[case]
        jcam, tcam = np_camera(W=256, H=64)
        scene = make()
        n = scene[0].shape[0]
        ones = np.ones(n, bool)
        jprep = jpreprocess.preprocess(*jax_args(scene), jnp.asarray(ones),
                                       jcam)
        tprep = preprocess.preprocess(*torch_args(scene), torch.tensor(ones),
                                      tcam)
        H, W, origin = 64, 256, None
        if window is not None:
            x0, y0, W, H = window
            origin = (float(x0), float(y0))
            jprep = jprep._replace(mx=jprep.mx - x0, my=jprep.my - y0)
            tprep = tprep._replace(mx=tprep.mx - x0, my=tprep.my - y0)
        n_ty, n_tx = jbinning.tile_grid(H, W, th, tw)
        jb = jbinning.bin_gaussians(
            jprep, H, W, th, tw, max_tiles_per_gaussian=n_ty * n_tx,
            tile_capacity=K, gate16=gate,
            gate_origin=None if origin is None else jnp.asarray(
                origin, jnp.float32))
        tb = binning.bin_gaussians(tprep, H, W, th, tw, tile_capacity=K,
                                   gate16=gate, gate_origin=origin)
        assert int(jb.n_dropped_pairs) == 0
        assert int(tb.n_dropped_pairs) == 0
        np.testing.assert_array_equal(tb.counts.numpy(),
                                      np.asarray(jb.counts))
        np.testing.assert_array_equal(tb.kmask.numpy(), np.asarray(jb.kmask))
        km = np.asarray(jb.kmask)
        np.testing.assert_array_equal(tb.gauss_index.numpy()[km],
                                      np.asarray(jb.gauss_index)[km])
        assert int(tb.n_truncated) == int(jb.n_truncated)
        if case == "truncated":
            assert int(tb.n_truncated) > 0


def _blend_inputs(scene, th, tw, K, gate, window):
    """JAX preprocess + binning of a scene -> the blend's inputs."""
    jcam, _ = np_camera(W=256, H=32)
    n = scene[0].shape[0]
    prep = jpreprocess.preprocess(*jax_args(scene), jnp.ones(n, bool), jcam)
    H, W, origin = 32, 256, (0.0, 0.0)
    bin_prep = prep
    if window is not None:
        x0, y0, W, H = window
        origin = (float(x0), float(y0))
        bin_prep = prep._replace(mx=prep.mx - x0, my=prep.my - y0)
    n_ty, n_tx = jbinning.tile_grid(H, W, th, tw)
    bins = jbinning.bin_gaussians(
        bin_prep, H, W, th, tw, max_tiles_per_gaussian=n_ty * n_tx,
        tile_capacity=K, gate16=gate,
        gate_origin=jnp.asarray(origin) if window is not None else None)
    return prep, bins, H, W, n_tx, origin


BLEND_CASES = {
    "tiles8x128": (lambda: np_scene(1, n=96, opacity_max=0.8), 8, 128, 64,
                   False, None),
    "gate_window32": (lambda: np_scene(2, n=160), 32, 32, 64, True,
                      (92, 12, 128, 32)),
    "saturated": (lambda: stacked_scene(opacity=0.95), 8, 128, 64, True,
                  None),
}


class TestBlendForward:
    @pytest.mark.parametrize("case", sorted(BLEND_CASES))
    def test_plain_matches_pallas_and_xla(self, case):
        make, th, tw, K, gate, window = BLEND_CASES[case]
        prep, bins, H, W, n_tx, origin = _blend_inputs(make(), th, tw, K,
                                                       gate, window)
        jconsts = jblend.BlendConsts(tile_h=th, tile_w=tw, n_tx=n_tx,
                                     ref_gate=gate)
        attrs16 = prep.attrs16()
        idx = bins.gauss_index
        paged = jblend._gather_pack(attrs16, idx, 16)
        C, T_p, nc_p = blend_pallas.blend_tiles_pallas_fwd(
            jconsts, n_tx, paged, bins.counts, jnp.asarray(origin))
        from gaussiancity_tpu.ops.rasterizer.api import _assemble_image

        n_ty = idx.shape[0] // n_tx

        def assemble(tiles_last):  # [T, TH, TW, C] -> [C, H, W]
            return np.asarray(_assemble_image(tiles_last, n_ty, n_tx, th,
                                              tw, H, W))

        want_img = assemble(jnp.moveaxis(C, 1, -1))
        want_T = assemble(T_p[..., None])[0]
        want_nc = assemble(nc_p[..., None])[0]

        consts = blend.BlendConsts(tile_h=th, tile_w=tw, n_tx=n_tx,
                                   ref_gate=gate)
        image, final_T, n_contrib, n_eval = blend.blend_forward_plain(
            torch.from_numpy(np.array(attrs16[:, :10])),
            torch.from_numpy(np.array(idx)),
            torch.from_numpy(np.array(bins.counts)), origin,
            torch.zeros(3), H, W, consts)
        np.testing.assert_allclose(image.numpy(), want_img, atol=BLEND_ATOL)
        np.testing.assert_allclose(final_T.numpy(), want_T, atol=BLEND_ATOL)
        np.testing.assert_array_equal(n_contrib.numpy(), want_nc)
        assert (n_eval >= n_contrib).all()
        assert int(n_contrib.max()) > 0

        # the XLA scan (_blend_fwd_impl) with a background
        bg = jnp.asarray([0.3, 0.1, 0.6])
        tid = jnp.arange(idx.shape[0])
        kvalid = (jnp.where(bins.kmask, prep.radius[idx], 0) if gate
                  else bins.kmask).astype(jnp.float32)
        out, T_x, nc_x = jblend._blend_fwd_impl(
            jconsts, prep.mean2d[idx], prep.conic[idx], prep.color[idx],
            prep.opacity[idx], kvalid,
            ((tid % n_tx) * tw).astype(jnp.float32) + origin[0],
            ((tid // n_tx) * th).astype(jnp.float32) + origin[1], bg)
        image_bg, final_T_bg, n_contrib_bg = blend.blend_forward(
            torch.from_numpy(np.array(attrs16[:, :10])),
            torch.from_numpy(np.array(idx)),
            torch.from_numpy(np.array(bins.counts)), origin,
            torch.from_numpy(np.array(bg)), H, W, consts)
        np.testing.assert_allclose(image_bg.numpy(), assemble(out),
                                   atol=BLEND_ATOL)
        np.testing.assert_allclose(final_T_bg.numpy(),
                                   assemble(T_x[..., None])[0],
                                   atol=BLEND_ATOL)
        np.testing.assert_array_equal(n_contrib_bg.numpy(),
                                      assemble(nc_x[..., None])[0])

    def test_wrapper_checks_inputs(self):
        consts = blend.BlendConsts(tile_h=8, tile_w=128, n_tx=2)
        attrs = torch.zeros(4, 10)
        idx = torch.zeros(4, 16, dtype=torch.int32)
        counts = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(TypeError):
            blend.blend_forward(attrs.double(), idx, counts, (0, 0),
                                torch.zeros(3), 32, 256, consts)
        with pytest.raises(ValueError):
            blend.blend_forward(attrs[:, :9], idx, counts, (0, 0),
                                torch.zeros(3), 32, 256, consts)
        with pytest.raises(ValueError):  # 4 tiles cannot cover 64 rows
            blend.blend_forward(attrs, idx, counts, (0, 0), torch.zeros(3),
                                64, 256, consts)


RASTER_CASES = {
    "seed0": (lambda: np_scene(0), {}, None, False),
    "seed1_gate32": (lambda: np_scene(1, n=512), dict(tile_h=32, tile_w=32),
                     None, True),
    "background": (lambda: np_scene(3, n=64), {}, None, False),
    "saturated": (lambda: stacked_scene(), {}, None, False),
    "window": (lambda: np_scene(3, n=512), {}, (96, 16, 128, 32), False),
    "window_gate_unaligned": (lambda: np_scene(3, n=512),
                              dict(tile_h=32, tile_w=32),
                              (92, 12, 128, 32), True),
}


class TestRasterize:
    @pytest.mark.parametrize("case", sorted(RASTER_CASES))
    def test_matches_jax(self, case):
        make, tiles, window, gate = RASTER_CASES[case]
        jcam, tcam = np_camera()
        scene = make()
        kw = dict(tile_capacity=512, ref_tile16_gate=gate, **tiles)
        jcfg = JRasterizerConfig(max_tiles_per_gaussian=64, backend="xla",
                                 **kw)
        bg = np.float32([0.2, 0.4, 0.8]) if case == "background" else None
        j = jrasterize(*jax_args(scene), jcam, jcfg, window=window,
                       bg=None if bg is None else jnp.asarray(bg))
        t = rasterize(*torch_args(scene), tcam, RasterizerConfig(**kw),
                      window=window,
                      bg=None if bg is None else torch.from_numpy(bg))
        np.testing.assert_allclose(t.image.numpy(), np.asarray(j.image),
                                   atol=1e-5)
        np.testing.assert_allclose(t.final_T.numpy(), np.asarray(j.final_T),
                                   atol=1e-5)
        np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
        for name in ("n_dropped_pairs", "n_truncated", "n_grad_truncated"):
            assert int(getattr(t, name)) == int(getattr(j, name)), name

    def test_shs_colors_match(self):
        from gaussiancity_tpu.ops.rasterizer import sh as jsh

        from gaussiancity_tpu_torch.ops.rasterizer import sh

        jcam, tcam = np_camera()
        means, op, sc, qu, _ = np_scene(5, n=128)
        shs = np.random.default_rng(5).normal(
            0, 0.3, (128, 16, 3)).astype(np.float32)
        for deg in range(4):
            np.testing.assert_allclose(
                sh.eval_sh_colors(torch.from_numpy(shs),
                                  torch.from_numpy(means), tcam.cam_pos,
                                  deg).numpy(),
                np.asarray(jsh.eval_sh_colors(jnp.asarray(shs),
                                              jnp.asarray(means),
                                              jcam.cam_pos, deg)),
                atol=1e-5)
        cfg = RasterizerConfig(tile_h=8, tile_w=128, tile_capacity=512)
        j = jrasterize(jnp.asarray(means), jnp.asarray(op), jnp.asarray(sc),
                       jnp.asarray(qu), None, jcam,
                       JRasterizerConfig(tile_h=8, tile_w=128,
                                         tile_capacity=512, backend="xla",
                                         max_tiles_per_gaussian=64),
                       shs=jnp.asarray(shs), sh_degree=2)
        t = rasterize(*torch_args((means, op, sc, qu)), None, tcam, cfg,
                      shs=torch.from_numpy(shs), sh_degree=2)
        np.testing.assert_allclose(t.image.numpy(), np.asarray(j.image),
                                   atol=1e-5)

    def test_gradient_raises(self):
        # the blend backward is once-differentiable: a second derivative
        # through the render raises
        _, tcam = np_camera(W=128, H=32)
        means, op, sc, qu, co = torch_args(np_scene(6, n=32))
        co.requires_grad_(True)
        out = rasterize(means, op, sc, qu, co, tcam,
                        RasterizerConfig(tile_h=8, tile_w=128))
        (g,) = torch.autograd.grad((out.image ** 2).sum(), co,
                                   create_graph=True)
        assert g.abs().max() > 0
        with pytest.raises(RuntimeError, match="differentiate twice"):
            g.sum().backward()

    def test_wrapper_flips(self):
        from gaussiancity_tpu.ops.rasterizer import (
            GaussianRasterizerWrapper as JWrapper)

        from gaussiancity_tpu_torch.ops.rasterizer import (
            GaussianRasterizerWrapper, mark_visible)

        K = np.array([[100.0, 0, 64], [0, 100.0, 16], [0, 0, 1]])
        scene = np_scene(7, n=64)
        pts = np.concatenate([scene[0], scene[1][:, None], scene[2],
                              scene[3], scene[4]], -1)
        cfg = dict(tile_h=8, tile_w=128, tile_capacity=256)
        pose = (np.zeros(3), np.array([0.0, 0, 0, 1]))
        j = JWrapper(K, (128, 32), flip_ud=True, cfg=JRasterizerConfig(
            backend="xla", **cfg))(jnp.asarray(pts), *pose)
        t = GaussianRasterizerWrapper(K, (128, 32), flip_ud=True,
                                      cfg=RasterizerConfig(**cfg))(
            torch.from_numpy(pts), *pose)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
        _, tcam = np_camera(W=128, H=32)
        vis = mark_visible(torch.from_numpy(scene[0]), tcam)
        np.testing.assert_array_equal(vis.numpy(), scene[0][:, 0] > 0.2)


# float32 sums over pixels and slots taken in another order than XLA's:
# tolerance relative to each gradient's largest magnitude
GRAD_RTOL = 2e-5

GRAD_CASES = {
    # scene, tiles, window, ref gate, background
    "tiles8x128_bg": (lambda: np_scene(3, n=256), dict(tile_h=8, tile_w=128),
                      None, False, True),
    "gate_window32": (lambda: np_scene(3, n=256), dict(tile_h=32, tile_w=32),
                      (92, 12, 128, 32), True, True),
    "dense_gate": (lambda: np_scene(4, n=384, opacity_max=0.99),
                   dict(tile_h=8, tile_w=128), None, True, False),
}


class TestRasterizeGradients:
    @pytest.mark.parametrize("case", sorted(GRAD_CASES))
    def test_matches_jax_grad(self, case):
        import jax

        make, tiles, window, gate, with_bg = GRAD_CASES[case]
        jcam, tcam = np_camera()
        scene = make()
        kw = dict(tile_capacity=512, ref_tile16_gate=gate, **tiles)
        jcfg = JRasterizerConfig(max_tiles_per_gaussian=64, backend="xla",
                                 **kw)
        rng = np.random.default_rng(1)
        H, W = (64, 256) if window is None else (window[3], window[2])
        w_img = rng.normal(size=(3, H, W)).astype(np.float32)
        w_T = rng.normal(size=(H, W)).astype(np.float32)
        bg = (np.float32([0.2, 0.4, 0.8]) if with_bg
              else np.zeros(3, np.float32))

        def jloss(*args):
            out = jrasterize(*args[:5], jcam, jcfg, bg=args[5],
                             window=window)
            return jnp.sum(out.image * w_img) + jnp.sum(out.final_T * w_T)

        want = jax.grad(jloss, argnums=tuple(range(6)))(
            *jax_args(scene), jnp.asarray(bg))
        targs = [a.requires_grad_(True)
                 for a in torch_args(scene) + [torch.from_numpy(bg)]]
        out = rasterize(*targs[:5], tcam, RasterizerConfig(**kw),
                        bg=targs[5], window=window)
        loss = ((out.image * torch.from_numpy(w_img)).sum()
                + (out.final_T * torch.from_numpy(w_T)).sum())
        loss.backward()
        assert int(out.n_grad_truncated) == 0
        for name, w, t in zip(("means", "opacities", "scales", "quats",
                               "colors", "bg"), want, targs):
            w = np.asarray(w)
            assert np.abs(w).max() > 0, name
            np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                       atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=name)

    @pytest.mark.parametrize("capacity,budget", [(0, 48), (32, 0), (24, 64)])
    def test_truncated_backward_matches_pallas(self, capacity, budget):
        """n_grad_truncated and the bounded per-Gaussian gradient against
        the JAX package's blend_gathered (Pallas, interpret mode) at page
        16, on a tile-aligned image where both count the same pixels.
        Without a budget the capacity is a whole number of pages: there
        the JAX package reduces whole pages, past a capacity that is not,
        while the port reduces exactly the slots its count keeps."""
        import jax

        th, tw, K, page = 8, 128, 64, 16
        prep, bins, H, W, n_tx, origin = _blend_inputs(
            crowded_scene(n=160), th, tw, K, False, None)
        jconsts = jblend.BlendConsts(tile_h=th, tile_w=tw, n_tx=n_tx,
                                     backend="pallas")
        attrs16 = prep.attrs16()
        idx, counts = bins.gauss_index, bins.counts
        bg = jnp.asarray([0.3, 0.1, 0.6])
        rng = np.random.default_rng(2)
        g_img = rng.normal(size=(3, H, W)).astype(np.float32)
        g_T = rng.normal(size=(H, W)).astype(np.float32)
        n_ty = idx.shape[0] // n_tx

        def to_tiles(x):  # [C, H, W] -> [T, TH, TW, C]
            C = x.shape[0]
            return jnp.asarray(x.reshape(C, n_ty, th, n_tx, tw).transpose(
                1, 3, 2, 4, 0).reshape(n_ty * n_tx, th, tw, C))

        def fwd(a16):
            return jblend.blend_gathered(
                jconsts, capacity, budget, page, a16,
                idx.astype(jnp.float32), counts.astype(jnp.float32),
                jnp.zeros(2), bg)

        (_, _, j_trunc), vjp = jax.vjp(fwd, attrs16)
        (d16,) = vjp((to_tiles(g_img), to_tiles(g_T[None])[..., 0],
                      np.zeros((), jax.dtypes.float0)))

        consts = blend.BlendConsts(tile_h=th, tile_w=tw, n_tx=n_tx)
        t_attrs = torch.from_numpy(np.array(attrs16[:, :10]))
        t_idx = torch.from_numpy(np.array(idx))
        t_counts = torch.from_numpy(np.array(counts))
        t_bg = torch.from_numpy(np.array(bg))
        _, final_T, n_contrib = blend.blend_forward(
            t_attrs, t_idx, t_counts, origin, t_bg, H, W, consts)
        k_hi = blend.tile_k_hi(t_counts, n_contrib, consts)
        trunc = blend.grad_trunc_count(k_hi, capacity, budget, K, page)
        assert int(trunc) == int(j_trunc) > 0
        g_image = torch.from_numpy(g_img)
        bg_dot_g = (t_bg[0] * g_image[0] + t_bg[1] * g_image[1]
                    + t_bg[2] * g_image[2] + torch.from_numpy(g_T))
        slots = blend.blend_backward(t_attrs, t_idx, k_hi, origin, g_image,
                                     bg_dot_g, final_T, n_contrib, consts)
        rows = blend.reduce_slot_grads(slots, t_idx, k_hi,
                                       t_attrs.shape[0], capacity, budget,
                                       page)
        want = np.asarray(d16)[:, :9]
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(rows.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max())


def _port_bins(scene, W, H, th, tw, K, gate, window):
    """The port's preprocess and binning of a scene -> the blend's
    inputs (attrs, bins, H, W, consts, origin)."""
    _, tcam = np_camera(W=W, H=H)
    n = scene[0].shape[0]
    prep = preprocess.preprocess(*torch_args(scene),
                                 torch.ones(n, dtype=torch.bool), tcam)
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
    return prep.attrs10(), bins, H, W, consts, origin


def _np_gate_pixels(attrs, idx, consts, origin, H, W):
    """Brute force in numpy float32: for every tile t, in-image pixel
    (iy, ix) and slot k, whether the reference gate holds -> [T, TH, TW,
    K] bool, and the in-image mask [T, TH, TW]."""
    a = attrs.numpy()[idx.numpy()]  # [T, K, 10]
    f16 = np.float32(0.0625)
    mx, my, rd = a[..., 0], a[..., 1], a[..., 9]
    xlo = np.floor((mx - rd) * f16)
    xhi = np.floor((mx + rd + np.float32(15.0)) * f16)
    ylo = np.floor((my - rd) * f16)
    yhi = np.floor((my + rd + np.float32(15.0)) * f16)
    T = idx.shape[0]
    th, tw = consts.tile_h, consts.tile_w
    t = np.arange(T)
    x0 = ((t % consts.n_tx) * tw).astype(np.float32) + np.float32(origin[0])
    y0 = ((t // consts.n_tx) * th).astype(np.float32) + np.float32(origin[1])
    px = x0[:, None] + np.arange(tw, dtype=np.float32)[None]  # [T, TW]
    py = y0[:, None] + np.arange(th, dtype=np.float32)[None]  # [T, TH]
    bx, by = np.floor(px * f16), np.floor(py * f16)
    gx = (bx[:, None, :, None] >= xlo[:, None, None, :]) \
        & (bx[:, None, :, None] < xhi[:, None, None, :])
    gy = (by[:, :, None, None] >= ylo[:, None, None, :]) \
        & (by[:, :, None, None] < yhi[:, None, None, :])
    inside = (((t % consts.n_tx) * tw)[:, None, None]
              + np.arange(tw)[None, None] < W) \
        & (((t // consts.n_tx) * th)[:, None, None]
           + np.arange(th)[None, :, None] < H)
    return gx & gy, inside


def _sub_tile_keep(attrs, gauss_index, n_slots, origin, img_h, img_w,
                   consts):
    """[T, S, K] bool: the kernels' cull (``blend_common.cuh`` locate and
    compact) in PyTorch.  Sub-tile s of tile t keeps slot k < n_slots[t]
    unless it has no in-image pixel or, with the reference gate, the
    slot's getRect block range misses every 16x16 block of its in-image
    pixels (then the gate fails at each of them)."""
    T, K = gauss_index.shape
    sub_h, sub_w = blend.sub_tile_shape(consts.tile_h, consts.tile_w)
    n_sx = -(-consts.tile_w // sub_w)
    n_sy = -(-consts.tile_h // sub_h)
    tid = torch.arange(T)
    tx, ty = tid % consts.n_tx, tid // consts.n_tx
    sub = torch.arange(n_sx * n_sy)
    sx0, sy0 = (sub % n_sx) * sub_w, (sub // n_sx) * sub_h
    sx1 = torch.minimum(torch.clamp(sx0 + sub_w, max=consts.tile_w)[None],
                        (img_w - tx * consts.tile_w)[:, None])
    sy1 = torch.minimum(torch.clamp(sy0 + sub_h, max=consts.tile_h)[None],
                        (img_h - ty * consts.tile_h)[:, None])
    x0 = (tx * consts.tile_w).float() + float(origin[0])
    y0 = (ty * consts.tile_h).float() + float(origin[1])

    def block(base, pix):
        return torch.floor((base[:, None] + pix.float()) * 0.0625)

    # the 16x16-block range of each sub-tile's in-image pixels, [T, S]
    bxl, bxh = block(x0, sx0[None]), block(x0, sx1 - 1)
    byl, byh = block(y0, sy0[None]), block(y0, sy1 - 1)
    nonempty = (sx1 > sx0) & (sy1 > sy0)
    keep = nonempty[:, :, None] & (
        torch.arange(K) < n_slots[:, None])[:, None]
    if consts.ref_gate:
        a = attrs[gauss_index.long()]  # [T, K, 10]
        xlo, xhi, ylo, yhi = (r[:, None] for r in
                              blend._gate_rect(a[..., 0], a[..., 1],
                                               a[..., 9]))
        keep = keep & ((xlo <= bxh[..., None]) & (xhi > bxl[..., None])
                       & (ylo <= byh[..., None]) & (yhi > byl[..., None]))
    return keep


WORK_CASES = {
    # scene, image (W, H), tiles (h, w), capacity, window
    "gate_window32": (lambda: np_scene(2, n=160), (256, 64), (32, 32), 64,
                      (92, 12, 128, 32)),
    "gate_tiles8x128": (lambda: np_scene(1, n=200), (256, 64), (8, 128), 64,
                        None),
    "gate_tiles16_edge": (lambda: np_scene(5, n=200), (200, 60), (16, 16),
                          64, None),
}


class TestSubTileWork:
    def test_sub_tiles_cover_every_tile(self):
        for th in range(1, 1025):
            for tw in range(1, 1024 // th + 1):
                sh, sw = blend.sub_tile_shape(th, tw)
                n = (-(-th // sh)) * (-(-tw // sw))
                assert sh * sw <= blend.SUB_TILE_PIXELS and sh <= th
                assert sw <= tw and n <= blend.MAX_SUB_TILES, (th, tw)
        assert blend.sub_tile_shape(32, 32) == (16, 16)
        assert blend.sub_tile_shape(8, 128) == (8, 32)

    @pytest.mark.parametrize("case", sorted(WORK_CASES))
    def test_cull_drops_no_gated_slot(self, case):
        make, (W, H), (th, tw), K, window = WORK_CASES[case]
        attrs, bins, H, W, consts, origin = _port_bins(
            make(), W, H, th, tw, K, True, window)
        keep = _sub_tile_keep(attrs, bins.gauss_index, bins.counts, origin,
                              H, W, consts).numpy()
        gate, inside = _np_gate_pixels(attrs, bins.gauss_index, consts,
                                       origin, H, W)
        sh, sw = blend.sub_tile_shape(th, tw)
        n_sx = -(-tw // sw)
        sub = (np.arange(th)[:, None] // sh) * n_sx \
            + np.arange(tw)[None] // sw  # [TH, TW]
        counts = bins.counts.numpy()
        live = np.arange(K)[None] < counts[:, None]  # [T, K]
        n_dropped = 0
        for s in range(keep.shape[1]):
            pix = inside & (sub == s)[None]  # [T, TH, TW]
            passes = (gate & pix[..., None]).any(axis=(1, 2))  # [T, K]
            dropped = live & ~keep[:, s]
            assert not (dropped & passes).any()
            assert not (keep[:, s] & ~live).any()  # only slots < count
            n_dropped += int((dropped & pix.any(axis=(1, 2))[:, None]).sum())
        # 16x16 tiles at a 16-aligned origin are one gate block each, which
        # binning already culls for
        assert (n_dropped == 0) == (case == "gate_tiles16_edge")

    @pytest.mark.parametrize("case", sorted(WORK_CASES))
    def test_blend_work_counts_gated_pairs(self, case):
        make, (W, H), (th, tw), K, window = WORK_CASES[case]
        attrs, bins, H, W, consts, origin = _port_bins(
            make(), W, H, th, tw, K, True, window)
        idx, counts = bins.gauss_index, bins.counts
        _, _, n_contrib, n_eval = blend.blend_forward_plain(
            attrs, idx, counts, origin, torch.zeros(3), H, W, consts)
        k_hi = blend.tile_k_hi(counts, n_contrib, consts)
        gate, inside = _np_gate_pixels(attrs, idx, consts, origin, H, W)
        T = idx.shape[0]
        sh, sw = blend.sub_tile_shape(th, tw)
        for n_slots, limit in ((counts, n_eval), (k_hi, n_contrib)):
            work = blend.blend_work(attrs, idx, n_slots, limit, origin,
                                    consts)
            lim = blend._to_tiles(limit, consts, T).numpy()
            lim = np.minimum(lim, n_slots.numpy()[:, None, None])
            lim = np.where(inside, lim, 0)
            tested = np.arange(K)[None, None, None] < lim[..., None]
            assert work.pairs == int((tested & gate).sum()) > 0
            assert 0 < work.eligible <= work.pairs
            tests = sum(int(lim[:, y:y + sh, x:x + sw].max(axis=(1, 2))
                            .sum()) for y in range(0, th, sh)
                        for x in range(0, tw, sw))
            assert work.sub_tile_tests == tests
