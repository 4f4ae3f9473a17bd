# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: the smoothness loss, the perceptual
loss's L2 and multi-scale options, the per-pixel oracle renderer, and the
port's rasterizer debug snapshots and profiling hooks.  Inputs are made
with numpy from a seed; VGG weights are carried by ``interop``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiancity_tpu.config import RasterizerConfig as JRasterizerConfig
from gaussiancity_tpu.losses.perceptual import PerceptualLoss as JPLoss
from gaussiancity_tpu.losses.smoothness import smoothness_loss as jsmooth
from gaussiancity_tpu.ops.rasterizer.naive import naive_render as jnaive

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.config import RasterizerConfig
from gaussiancity_tpu_torch.losses import PerceptualLoss, smoothness_loss
from gaussiancity_tpu_torch.ops.rasterizer import debug, rasterize
from gaussiancity_tpu_torch.ops.rasterizer.naive import naive_render
from gaussiancity_tpu_torch.utils import profiling
from gaussiancity_tpu_torch.testing import share_cpu_cores
from test_torch_model_options import _rel_close
from test_torch_ptv3 import _np_tree
from test_torch_rasterizer import jax_args, np_camera, np_scene, torch_args

share_cpu_cores()

# float32 convolutions and sums in another order than XLA's
RTOL = 1e-4


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_diag", [True, False])
def test_smoothness_loss_matches_jax(use_diag):
    rng = np.random.default_rng(13)
    a = rng.normal(size=(2, 20, 24, 1)).astype(np.float32)
    b = rng.normal(size=(2, 20, 24, 1)).astype(np.float32) * 0.3
    want, want_g = jax.value_and_grad(
        lambda x: jsmooth(x, jnp.asarray(b), use_diag))(jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_(True)
    got = smoothness_loss(ta, torch.from_numpy(b), use_diag)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _rel_close(ta.grad, want_g, 1e-5)


def test_perceptual_l2_two_scales_matches_jax():
    """criterion "l2" at two scales (the second on the 2x2 average pool),
    float32: the loss within 1e-4 relative, the input gradient within
    1e-4 of its largest."""
    layers, weights = ("relu_1_1", "relu_2_1"), (0.5, 1.0)
    kw = dict(layers=layers, weights=weights, criterion="l2", num_scales=2)
    jp = JPLoss(**kw)
    params = _np_tree(jp.init(jax.random.PRNGKey(1)))
    tp = PerceptualLoss(**kw)
    tp.model.load_state_dict(interop.vgg_state_from_flax(params))
    rng = np.random.default_rng(14)
    a = rng.uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda x: jp(params, x, jnp.asarray(b)))(jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_(True)
    got = tp(ta, torch.from_numpy(b))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    _rel_close(ta.grad, want_g)
    one = PerceptualLoss(layers=layers, weights=weights, criterion="l2")
    one.model.load_state_dict(tp.model.state_dict())
    assert float(one(ta, torch.from_numpy(b))) < float(got)
    with pytest.raises(ValueError, match="criterion"):
        PerceptualLoss(criterion="huber")


# ---------------------------------------------------------------------------
# rasterizer oracle, debug snapshots, profiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate", [True, False])
def test_naive_render_matches_jax_and_rasterize(gate):
    """The per-pixel oracle against the JAX one (image, final T and the
    gradients of means, opacities and colours within 1e-5 absolute /
    1e-4 of the largest) and against the port's tiled ``rasterize``
    (image and final T within 1e-5)."""
    jcam, tcam = np_camera(W=64, H=48, f=40.0)
    scene = np_scene(3, n=48)
    kw = dict(tile_h=16, tile_w=16, tile_capacity=256,
              ref_tile16_gate=gate)
    jcfg = JRasterizerConfig(**kw)
    cfg = RasterizerConfig(**kw)
    ct = np.random.default_rng(15).normal(size=(3, 48, 64)).astype(
        np.float32)

    def jloss(m, o, c):
        a = jax_args(scene)
        img, _ = jnaive(m, o, a[2], a[3], c, jcam, jcfg)
        return jnp.sum(img * ct)

    jimg, jT = jnaive(*jax_args(scene), jcam, jcfg)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(scene[i]) for i in (0, 1, 4)))
    targs = torch_args(scene)
    for i in (0, 1, 4):
        targs[i].requires_grad_(True)
    img, T = naive_render(*targs, tcam, cfg)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg),
                               atol=1e-5)
    np.testing.assert_allclose(T.detach().numpy(), np.asarray(jT),
                               atol=1e-5)
    assert np.asarray(jimg).max() > 0.1 and np.asarray(jT).min() < 0.9
    (img * torch.from_numpy(ct)).sum().backward()
    for i, g in zip((0, 1, 4), jg):
        _rel_close(targs[i].grad, g, what=str(i))
    out = rasterize(*torch_args(scene), tcam, cfg)
    np.testing.assert_allclose(out.image.numpy(), img.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out.final_T.numpy(), T.detach().numpy(),
                               atol=1e-5)


def test_rasterize_checked_dumps_and_raises(tmp_path):
    """A finite scene renders and writes nothing, and so does one with a
    NaN mean: preprocess culls that Gaussian, in the JAX package too.  A
    NaN colour of a visible Gaussian reaches the image: every input is
    dumped (numpy arrays, the camera on the CPU, the config), the call
    raises, and the snapshot replays to a non-finite render."""
    jcam, tcam = np_camera(W=64, H=48, f=40.0)
    cfg = RasterizerConfig(tile_h=16, tile_w=16)
    scene = torch_args(np_scene(4, n=32))
    path = str(tmp_path / "snap" / "fw.pkl")
    out = debug.rasterize_checked(*scene, tcam, cfg, snapshot_path=path)
    assert torch.isfinite(out.image).all() and not os.path.exists(path)
    assert int(out.radii[3]) > 0
    nan_mean = [a.clone() for a in scene]
    nan_mean[0][3, 1] = float("nan")
    out = debug.rasterize_checked(*nan_mean, tcam, cfg, snapshot_path=path)
    assert int(out.radii[3]) == 0 and not os.path.exists(path)
    from gaussiancity_tpu.ops.rasterizer import rasterize as jrasterize
    jout = jrasterize(*(jnp.asarray(a.numpy()) for a in nan_mean), jcam,
                      JRasterizerConfig(tile_h=16, tile_w=16, backend="xla"))
    assert np.isfinite(np.asarray(jout.image)).all()
    scene[4] = scene[4].clone()
    scene[4][0, 1] = float("nan")
    with pytest.raises(FloatingPointError, match="fw.pkl"):
        debug.rasterize_checked(*scene, tcam, cfg, snapshot_path=path,
                                bg=torch.ones(3))
    snap = debug.load_snapshot(path)
    assert sorted(snap["arrays"]) == ["bg", "colors", "means3d",
                                      "opacities", "quats", "scales"]
    assert np.isnan(snap["arrays"]["colors"][0, 1])
    assert snap["cfg"] == cfg and snap["cam"].img_w == 64
    assert snap["cam"].view_matrix.device.type == "cpu"
    replay = rasterize(**{k: torch.from_numpy(v)
                          for k, v in snap["arrays"].items()},
                       cam=snap["cam"], cfg=snap["cfg"])
    assert not torch.isfinite(replay.image).all()
    out = debug.rasterize_checked(*scene, tcam, cfg, snapshot_path=path,
                                  raise_on_nonfinite=False)
    assert not torch.isfinite(out.image).all()


def test_profiling_trace_and_timer(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        for step in range(2):
            with profiling.step_annotation("train", step):
                torch.ones(64).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"gct/train#0", "gct/train#1"} <= names
    with open(tmp_path / "trace.json") as fp:
        events = json.load(fp)["traceEvents"]
    assert any(e.get("name") == "gct/train#1" for e in events)
