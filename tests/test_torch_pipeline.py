# -*- coding: utf-8 -*-
"""The slice as a whole: the port's ``InferencePipeline.render_trajectory``
against the JAX package's, on the tiny REST config and synthetic city of
tests/test_inference.py with converted weights, on the dense path and on
the compact per-class path.  Also: the port imports nothing of JAX, and
its entry points never carry on quietly on the CPU."""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiancity_tpu.inference import pipeline as jpipeline
from gaussiancity_tpu.models import Generator as JGenerator
from gaussiancity_tpu.ops import visibility as jvis

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.inference import pipeline
from gaussiancity_tpu_torch.models.generator import Generator

from test_inference import synthetic_projections, tiny_cfg

ROOT = Path(__file__).resolve().parents[1]


class _JaxPipelineExactIds(jpipeline.InferencePipeline):
    """The JAX pipeline with its visible-point selection taken straight
    from the raycast's point-index map.  Its own ``visible_points`` keeps
    ``seen[2:]`` of the id-indexed bitmask, which returns point ``i - 1``
    for a visible point ``i``; the port returns point ``i``.  Everything
    after the selection is the JAX package's own code."""

    def visible_points(self, points, cam_pos, cam_quat):
        _, road = super().visible_points(points, cam_pos, cam_quat)
        if not hasattr(self, "_vp_fn"):
            W, H = self.ds.sensor_size
            K = np.asarray(self.ds.cam_k).reshape(3, 3)
            self._vp_fn = jax.jit(functools.partial(
                jvis.visible_from_volume, cam_f=float(K[0, 0]),
                cam_c=(float(K[1, 2]), float(K[0, 2])), img_dims=(H, W)))
        mins = points[:, :3].min(0)
        offsets = np.array([mins[0], mins[1], mins[2] - 1], np.int32)
        vp_map, _ = self._vp_fn(
            self._vol, self._pts_dev, jnp.asarray(cam_pos, jnp.float32),
            jnp.asarray(cam_quat, jnp.float32), offsets=jnp.asarray(offsets),
            occupancy=self._occ)
        vp = np.asarray(vp_map)
        return points[np.unique(vp[vp >= 0])], road


@pytest.fixture(scope="module")
def rest_pair():
    """The tiny REST generator in both packages with the same weights."""
    cfg = tiny_cfg()
    P, N = cfg.dataset.proj_size, 2048
    gen = JGenerator(cfg=cfg.network, n_classes=8, proj_size=P)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(gen.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, N, 2)), jnp.zeros((1, N, 3)),
        None, jnp.zeros((1, N, 8)), None, jnp.zeros((1, P, P, 1)),
        jnp.zeros((1, P, P, 8)), jnp.ones((1, N), bool))["params"])
    # widen the +-1e-4 init table so that the hash grid shows in the frame
    params["pos_encoder"]["embeddings"] = np.random.default_rng(0).uniform(
        -1, 1, params["pos_encoder"]["embeddings"].shape).astype(np.float32)
    tcfg = Config.from_dict(cfg.to_dict())
    tgen = Generator(tcfg.network, n_classes=8, proj_size=P)
    tgen.load_state_dict(interop.generator_state_from_flax(params,
                                                           tcfg.network))
    return cfg, tcfg, gen, params, tgen


@pytest.mark.parametrize("budgets", [None, {"REST": 2048}],
                         ids=["dense", "compact"])
def test_render_trajectory_matches_jax(rest_pair, budgets, monkeypatch):
    cfg, tcfg, gen, params, tgen = rest_pair
    P, N = cfg.dataset.proj_size, 2048
    projections = synthetic_projections(P)
    centers = {i: (32.0, 32.0, 64.0, 64.0, 20.0) for i in range(200)}
    # two poses off the map axes: at 0 and 180 degrees the view direction
    # has a ~1e-16 component, for which the JAX march misses whole pixel
    # columns (test_torch_visibility.py::TestRaycast::test_near_axis_rays)
    poses = jpipeline.get_orbit_camera_poses(P, n_points=6, radius=30,
                                             altitude=30)[1:3]
    tposes = pipeline.get_orbit_camera_poses(P, n_points=6, radius=30,
                                             altitude=30)[1:3]
    for a, b in zip(poses, tposes):
        assert a.keys() == b.keys()
        np.testing.assert_allclose([b[k] for k in a], [a[k] for k in a],
                                   atol=1e-12)

    jpipe = _JaxPipelineExactIds(cfg, {"REST": (gen, params)}, max_points=N,
                                 vol_shape=(72, 72, 24),
                                 class_budgets=budgets)
    jfloat, jcounts = [], []
    to_u8 = jpipe.frame_to_uint8
    jpipe.frame_to_uint8 = lambda img: (jfloat.append(np.asarray(img)),
                                        to_u8(img))[1]
    jvisible = jpipe.visible_points
    jpipe.visible_points = lambda *a: (
        lambda out: (jcounts.append(len(out[0])), out)[1])(jvisible(*a))
    jframes = jpipe.render_trajectory(projections, centers, poses)

    tpipe = pipeline.InferencePipeline(
        tcfg, {"REST": tgen}, max_points=N, vol_shape=(72, 72, 24),
        class_budgets=budgets, device="cpu")
    tfloat = []
    u8 = pipeline.frame_to_uint8
    monkeypatch.setattr(pipeline, "frame_to_uint8", lambda img: (
        tfloat.append(img.numpy().copy()), u8(img))[1])
    tframes = tpipe.render_trajectory(projections, centers, tposes)

    assert len(tframes) == len(jframes) == 2
    for i in range(2):
        # the float frame before the uint8 cast
        np.testing.assert_allclose(tfloat[i], jfloat[i], atol=1e-4)
        a, b = jframes[i].astype(int), tframes[i].astype(int)
        assert b.shape == a.shape and tframes[i].dtype == np.uint8
        diff = np.abs(a - b)
        assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
        assert a.std() > 1
        # points fed to the generator: the budget caps the visible set
        assert tpipe.frame_stats[i]["n_visible"] == min(jcounts[i], N)
        assert jcounts[i] > N  # the nearest-first budget is exercised
    assert set(tpipe.stage_ms) >= {"extrude", "volume", "raycast",
                                   "generator", "rasterize", "blur"}


@pytest.fixture(scope="module")
def bldg_pair():
    """A tiny BLDG generator (sin/cos, style z, the small PTv3) in both
    packages with the same weights and random running statistics."""
    from gaussiancity_tpu.config import GaussianNetworkConfig as JNet
    from gaussiancity_tpu.config import PTv3Config as JPTv3
    from test_torch_models import _net_kwargs
    from test_torch_ptv3 import TINY as TINY_PTV3

    from gaussiancity_tpu_torch.config import GaussianNetworkConfig, PTv3Config

    kw = _net_kwargs("bldg")
    jnet = JNet(**kw, ptv3=JPTv3(enabled=True, **TINY_PTV3))
    P, N, Z = 64, 1024, kw["z_dim"]
    gen = JGenerator(cfg=jnet, n_classes=8, proj_size=P)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(gen.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, N, 2)), jnp.zeros((1, N, 3)),
        None, jnp.zeros((1, N, 8)), jnp.zeros((1, N, Z)),
        jnp.zeros((1, P, P, 1)), jnp.zeros((1, P, P, 8)),
        jnp.ones((1, N), bool))))
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
        variables["batch_stats"])
    tnet = GaussianNetworkConfig(**kw, ptv3=PTv3Config(enabled=True,
                                                       **TINY_PTV3))
    tgen = Generator(tnet, n_classes=8, proj_size=P)
    tgen.load_state_dict(interop.generator_state_from_flax(variables, tnet))
    return gen, variables, tgen, Z


def test_two_model_compact_trajectory_matches_jax(rest_pair, bldg_pair,
                                                  monkeypatch):
    """REST + BLDG on the compact path, the style table passed as the JAX
    benchmark passes it (the default table has the REST model's width)."""
    cfg, tcfg, gen, params, tgen = rest_pair
    bgen, bvars, tbgen, Z = bldg_pair
    P = cfg.dataset.proj_size
    budgets = {"REST": 2048, "BLDG": 2048}
    projections = synthetic_projections(P)
    centers = {i: (32.0, 32.0, 64.0, 64.0, 20.0) for i in range(200)}
    lut = pipeline.get_style_lut(centers, Z, seed=0)
    poses = jpipeline.get_orbit_camera_poses(P, n_points=6, radius=30,
                                             altitude=30)[1:3]
    tposes = pipeline.get_orbit_camera_poses(P, n_points=6, radius=30,
                                             altitude=30)[1:3]
    jpipe = _JaxPipelineExactIds(
        cfg, {"REST": (gen, params), "BLDG": (bgen, bvars)},
        max_points=4096, vol_shape=(72, 72, 24), class_budgets=budgets)
    jfloat = []
    to_u8 = jpipe.frame_to_uint8
    jpipe.frame_to_uint8 = lambda img: (jfloat.append(np.asarray(img)),
                                        to_u8(img))[1]
    jframes = jpipe.render_trajectory(projections, centers, poses,
                                      style_lut=lut)

    tpipe = pipeline.InferencePipeline(
        tcfg, {"REST": tgen, "BLDG": tbgen}, max_points=4096,
        vol_shape=(72, 72, 24), class_budgets=budgets, device="cpu")
    tfloat = []
    u8 = pipeline.frame_to_uint8
    monkeypatch.setattr(pipeline, "frame_to_uint8", lambda img: (
        tfloat.append(img.numpy().copy()), u8(img))[1])
    tframes = tpipe.render_trajectory(projections, centers, tposes,
                                      style_lut=lut)
    assert len(tframes) == len(jframes) == 2
    for i in range(2):
        np.testing.assert_allclose(tfloat[i], jfloat[i], atol=1e-4)
        a, b = jframes[i].astype(int), tframes[i].astype(int)
        diff = np.abs(a - b)
        assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
        assert a.std() > 1
    for name in ("REST", "BLDG"):
        assert len(tpipe.stage_ms[f"generator_{name}"]) == 2
    # the BLDG generator saw points, and its features reach the frame
    assert all(st["n_visible"] > 0 for st in tpipe.frame_stats)
    with torch.no_grad():
        tbgen.pt_net.net.embedding_norm.bias.add_(1.0)
    again = tpipe.render_trajectory(projections, centers, tposes[:1],
                                    style_lut=lut)
    assert (again[0] != tframes[0]).any()
    # the default style table has the REST model's z width (1): the BLDG
    # model cannot take it, in the port as in the JAX package
    with pytest.raises(RuntimeError):
        tpipe.render_trajectory(projections, centers, tposes[:1])


def test_host_helpers_match_jax():
    rng = np.random.default_rng(0)
    pos, at = rng.normal(size=3) * 50, rng.normal(size=3) * 5
    np.testing.assert_allclose(pipeline.get_quat_from_look_at(pos, at),
                               jpipeline.get_quat_from_look_at(pos, at),
                               atol=1e-12)
    centers = {1: (0.0,) * 5}
    np.testing.assert_array_equal(
        pipeline.get_style_lut(centers, 4, z_bank={3: np.ones(4)},
                               max_instances=64),
        jpipeline.get_style_lut(centers, 4, z_bank={3: np.ones(4)},
                                max_instances=64))
    pts9 = rng.normal(size=(50, 9)).astype(np.float32)
    for budget in (10, 50, 80):
        for got, want in zip(pipeline.select_nearest(pts9, pos, budget),
                             jpipeline.select_nearest(pts9, pos, budget)):
            np.testing.assert_array_equal(got, want)
    img = rng.random((12, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pipeline._gaussian_blur3(torch.from_numpy(img)).numpy(),
        np.asarray(jpipeline._gaussian_blur3(jnp.asarray(img))), atol=1e-6)


def test_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.from_dict(tiny_cfg().to_dict())
    gen = Generator(cfg.network, n_classes=8, proj_size=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.InferencePipeline(cfg, {"REST": gen})
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.InferencePipeline(cfg, {"REST": gen}, device="cuda")
    pipeline.InferencePipeline(cfg, {"REST": gen}, device="cpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_no_jax():
    files = sorted((ROOT / "gaussiancity_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20 and all(f.exists() for f in files)
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "gaussiancity_tpu")
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in banned:
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad
    # and the text never names the JAX package as a module to load
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert not s.split()[1].startswith(
                    ("jax", "flax", "gaussiancity_tpu.")), (f, s)
