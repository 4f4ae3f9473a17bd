# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: the band-sharded rasterizer and the
sharded two-model frame on two ranks (two gloo processes on the CPU)
against ``make_sharded_rasterizer`` / ``make_sharded_frame`` on a
two-device mesh of the virtual CPU devices, with the tolerances of
tests/test_sharded_raster.py; also the compact path's point mask."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import __graft_entry__ as ge
from gaussiancity_tpu.camera import CameraModel as JCameraModel
from gaussiancity_tpu.config import Config as JConfig
from gaussiancity_tpu.config import RasterizerConfig as JRasterizerConfig
from gaussiancity_tpu.inference.pipeline import (
    InferencePipeline as JInferencePipeline)
from gaussiancity_tpu.models import Generator as JGenerator
from gaussiancity_tpu.ops.rasterizer import rasterize as jrasterize
from gaussiancity_tpu.parallel.sharded_infer import (
    make_sharded_frame as jmake_sharded_frame)
from gaussiancity_tpu.parallel.sharded_raster import (
    make_sharded_rasterizer as jmake_sharded_rasterizer)

from gaussiancity_tpu_torch import interop, testing
from gaussiancity_tpu_torch.camera import CameraModel
from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.inference.pipeline import InferencePipeline
from gaussiancity_tpu_torch.models.generator import Generator
from gaussiancity_tpu_torch.ops.rasterizer import rasterize
from gaussiancity_tpu_torch.parallel.launch import spawn_ranks
from gaussiancity_tpu_torch.parallel.sharded_raster import band_height
from gaussiancity_tpu_torch.testing import share_cpu_cores
from test_rasterizer import make_scene

share_cpu_cores()

# tests/test_sharded_raster.py: image atol / rtol, gradients atol
# relative to each gradient's largest magnitude
IMG_ATOL, IMG_RTOL = 3e-5, 1e-4
GRAD_REL = 1e-4
RANK_TIMEOUT_S = 240

JCFG = JRasterizerConfig(tile_h=8, tile_w=128, max_tiles_per_gaussian=64,
                         tile_capacity=256, backend="xla")
CFG = Config.from_dict(JConfig(rasterizer=JCFG).to_dict()).rasterizer


def _mesh():
    return Mesh(np.asarray(jax.devices()[:2]), ("tile",))


def _cam_args(W, H):
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])
    return K, (W, H), np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0])


class TestShardedRasterizer:
    @pytest.mark.parametrize("H", [64, 60])
    def test_image_and_gradients_match_jax(self, H, tmp_path):
        """H 64 splits into two bands of 32 rows; H 60 into bands of 32
        whose last 4 rows are padding that the crop drops."""
        W = 256
        assert band_height(H, CFG.tile_h, 2) == 32
        cam_args = _cam_args(W, H)
        jcam = JCameraModel(*cam_args[:2]).params(*cam_args[2:])
        scene = [np.asarray(a) for a in make_scene(jax.random.PRNGKey(1),
                                                   n=256)]
        valid = np.ones(256, bool)
        valid[::17] = False
        bg = np.array([0.1, 0.2, 0.3], np.float32)

        fn = jmake_sharded_rasterizer(_mesh(), jcam, JCFG)

        def loss(*s):
            return jnp.sum(fn(*s, jnp.asarray(valid), jnp.asarray(bg)) ** 2)

        js = [jnp.asarray(a) for a in scene]
        jimg = np.asarray(jax.jit(fn)(*js, jnp.asarray(valid),
                                      jnp.asarray(bg)))
        jgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*js)
        assert jimg.shape == (3, H, W)

        cam = CameraModel(*cam_args[:2]).params(*cam_args[2:], device="cpu")
        ranks = spawn_ranks(testing.sharded_raster_rank, 2,
                            str(tmp_path / "store"),
                            args=(scene, valid, bg, cam, CFG), device="cpu",
                            timeout_s=RANK_TIMEOUT_S)
        img = ranks[0]["image"]
        assert torch.equal(img, ranks[1]["image"])
        np.testing.assert_allclose(img.numpy(), jimg, atol=IMG_ATOL,
                                   rtol=IMG_RTOL)
        # against the port's own single-device render and its backward;
        # the bands are the render's tile rows, so their summed counters
        # are its counters, and the band backward has no slot budget
        args = [torch.from_numpy(a.copy()).requires_grad_(True)
                for a in scene]
        bg_t = torch.from_numpy(bg).requires_grad_(True)
        out = rasterize(*args, cam, CFG, valid=torch.from_numpy(valid),
                        bg=bg_t)
        ref = out.image
        np.testing.assert_allclose(img.numpy(), ref.detach().numpy(),
                                   atol=IMG_ATOL, rtol=IMG_RTOL)
        want = [int(out.n_dropped_pairs), int(out.n_truncated), 0]
        assert ranks[0]["counts"] == ranks[1]["counts"] == want
        (ref ** 2).sum().backward()
        names = "means opacities scales quats colors".split()
        for k, name in enumerate(names):
            got = torch.cat([r["grads"][k] for r in ranks]).numpy()
            for want in (np.asarray(jgrads[k]), args[k].grad.numpy()):
                scale = max(np.abs(want).max(), 1e-8)
                np.testing.assert_allclose(got / scale, want / scale,
                                           atol=GRAD_REL, err_msg=name)
        want_bg = bg_t.grad.numpy()
        for r in ranks:
            np.testing.assert_allclose(
                r["bg_grad"].numpy(), want_bg, rtol=0,
                atol=GRAD_REL * np.abs(want_bg).max())


def _frame_case():
    """tests/test_sharded_raster.py's composition at two devices: a REST
    and a BLDG (PTv3) generator from flax inits, a REST slab of 16 rows (12
    real) and a BLDG slab of 32 (24 real)."""
    cfg = ge._tiny_cfg("xla")
    cfg_b = ge._tiny_cfg("xla", ptv3=True)
    P = cfg.dataset.proj_size
    ncls = cfg.dataset.n_classes

    def init_gen(net_cfg, seed, z_dim):
        gen = JGenerator(cfg=net_cfg, n_classes=ncls, proj_size=P)
        variables = jax.jit(gen.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, 64, 2)),
            jnp.zeros((1, 64, 3)), None, jnp.zeros((1, 64, ncls)),
            jnp.zeros((1, 64, z_dim)) if z_dim else None,
            jnp.zeros((1, P, P, 1)), jnp.zeros((1, P, P, ncls)),
            jnp.ones((1, 64), bool))
        return gen, dict(variables)

    models = {"REST": init_gen(cfg.network, 0, None),
              "BLDG": init_gen(cfg_b.network, 1, cfg_b.network.z_dim)}
    rng = np.random.default_rng(3)

    def bucket(slab, count, lo, hi):
        pts9 = np.zeros((slab, 9), np.float32)
        pts9[:, 0] = rng.uniform(5, 30, slab)
        pts9[:, 1] = rng.uniform(-10, 10, slab)
        pts9[:, 2] = rng.uniform(-3, 3, slab)
        pts9[:, 3] = 1.0
        pts9[:, 4] = rng.integers(lo, hi, slab)
        pts9[:, 5:8] = rng.uniform(-1, 1, (slab, 3))
        return pts9, count

    buckets = {"REST": bucket(16, 12, 1, 8), "BLDG": bucket(32, 24, 100,
                                                            1024)}
    lut = rng.random((2048, cfg_b.network.z_dim)).astype(np.float32)
    proj_hf = np.zeros((P, P, 1), np.float32)
    proj_seg = np.zeros((P, P, ncls), np.float32)
    # the JAX compact path on each padded slab with its mask, jitted
    jpipe = JInferencePipeline(cfg, models, max_points=512)
    predict = jax.jit(jpipe.predict_attrs_single, static_argnums=(0,))
    jpreds = {name: np.asarray(predict(
        name, v, jnp.asarray(buckets[name][0]),
        jnp.arange(len(buckets[name][0])) < buckets[name][1],
        jnp.asarray(proj_hf), jnp.asarray(proj_seg), None, jnp.asarray(lut)))
        for name, (_, v) in models.items()}
    nets = {"REST": cfg.network, "BLDG": cfg_b.network}
    port_cfg = Config.from_dict(cfg.to_dict())
    port_models = {
        name: (Config.from_dict(cfg.replace(network=nets[name]).to_dict())
               .network,
               interop.generator_state_from_flax(
                   jax.tree_util.tree_map(np.asarray, v), nets[name]))
        for name, (_, v) in models.items()}
    return dict(cfg=cfg, models=models, buckets=buckets, lut=lut,
                proj_hf=proj_hf, proj_seg=proj_seg, port_cfg=port_cfg,
                port_models=port_models, jpreds=jpreds)


@pytest.fixture(scope="module")
def frame_case():
    return _frame_case()


def _port_pipeline(case):
    gens = {}
    for name, (net, state) in case["port_models"].items():
        g = Generator(net, n_classes=case["port_cfg"].dataset.n_classes,
                      proj_size=case["port_cfg"].dataset.proj_size)
        g.load_state_dict(state)
        gens[name] = g
    return InferencePipeline(case["port_cfg"], gens, device="cpu")


class TestShardedFrame:
    def test_frame_matches_jax(self, frame_case, tmp_path):
        c = frame_case
        W, H = 256, 16
        cam_args = _cam_args(W, H)
        jcam = JCameraModel(*cam_args[:2]).params(*cam_args[2:])
        pipe = JInferencePipeline(c["cfg"], c["models"], max_points=512)
        frame = jmake_sharded_frame(_mesh(), pipe, jcam, c["cfg"].rasterizer)
        bg = np.zeros(3, np.float32)
        jimg = np.asarray(frame(
            {k: (jnp.asarray(p), n) for k, (p, n) in c["buckets"].items()},
            jnp.asarray(c["proj_hf"]), jnp.asarray(c["proj_seg"]),
            jnp.asarray(c["lut"]), jnp.asarray(bg)))
        assert np.abs(jimg).max() > 0
        cam = CameraModel(*cam_args[:2]).params(*cam_args[2:], device="cpu")
        ranks = spawn_ranks(
            testing.sharded_frame_rank, 2, str(tmp_path / "store"),
            args=(c["port_cfg"], c["port_models"],
                  [{"buckets": c["buckets"], "cam": cam}],
                  (c["proj_hf"], c["proj_seg"], c["lut"])), device="cpu",
            timeout_s=RANK_TIMEOUT_S)
        (got,), (got1,) = ranks
        assert torch.equal(got["image"], got1["image"])
        assert got["counts"] == got1["counts"]
        assert got["counts"][2] == 0
        np.testing.assert_allclose(got["image"].numpy(), jimg,
                                   atol=IMG_ATOL, rtol=IMG_RTOL)
        # the single-device JAX composition gives the same frame
        from gaussiancity_tpu.parallel.sharded_infer import unpack_points14
        gs = jnp.concatenate([jnp.asarray(c["jpreds"][name])
                              for name in c["models"]])
        masks = jnp.concatenate([jnp.arange(len(p)) < n for p, n in (
            c["buckets"][name] for name in c["models"])])
        ref = jrasterize(*unpack_points14(gs), jcam, c["cfg"].rasterizer,
                         valid=masks, bg=jnp.asarray(bg)).image
        np.testing.assert_allclose(got["image"].numpy(), np.asarray(ref),
                                   atol=IMG_ATOL, rtol=IMG_RTOL)


class TestPointMask:
    def test_compact_path_mask(self, frame_case):
        """An all-true mask gives the unmasked result bit for bit; on the
        padded BLDG slab the port with the mask matches the JAX compact
        path with it, and the mask changes PTv3's output."""
        c = frame_case
        pipe = _port_pipeline(c)
        args = [torch.from_numpy(c[k]) for k in ("proj_hf", "proj_seg")]
        lut = torch.from_numpy(c["lut"])
        for name in ("REST", "BLDG"):
            pts9, n = c["buckets"][name]
            real = torch.from_numpy(pts9[:n])
            with torch.no_grad():
                plain = pipe.predict_attrs_single(name, real, *args, None,
                                                  lut)
                ones = pipe.predict_attrs_single(
                    name, real, *args, None, lut,
                    pts_mask=torch.ones(n, dtype=torch.bool))
                mask = torch.arange(len(pts9)) < n
                padded = pipe.predict_attrs_single(
                    name, torch.from_numpy(pts9), *args, None, lut,
                    pts_mask=mask)
                unmasked = pipe.predict_attrs_single(
                    name, torch.from_numpy(pts9), *args, None, lut)
            assert torch.equal(plain, ones), name
            want = c["jpreds"][name]
            np.testing.assert_allclose(padded[:n].numpy(), want[:n],
                                       atol=1e-4, err_msg=name)
            if name == "BLDG":
                assert not torch.allclose(unmasked[:n], padded[:n])
