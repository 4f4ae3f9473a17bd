# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: the BLDG GAN train step at batch
size 2 on one device.

The JAX ``Trainer`` takes one sample a device: its batch of 2 runs on two
devices, each with its own PTv3 BatchNorm statistics.  The port's
``Trainer`` takes B = 2 on one device and pools the BatchNorm statistics
over both samples, as upstream's packed PTv3 does.  Its reference here is
built from the JAX package's own pieces: ``Trainer.train_step`` with a
``_render_fake`` that calls the generator once over the batch (PTv3's
``nn.vmap``, whose BatchNorm ``psum``s span the samples), then
``rasterize_points14`` per sample with that sample's camera and crop, the
flips, and the stacked image; the D, perceptual and GAN losses on the
stacked fake, ``jax.grad`` and Adam are the package's own.

The two samples differ in points, camera and crop, and the second has a
quarter of its rows masked (they lie in view, so a render or a BatchNorm
that took them in would differ).  Tolerances are those of
``test_torch_bldg_training.TestBldgTrainStep``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiancity_tpu.ops.rasterizer import (
    rasterize_points14 as jrasterize_points14)
from gaussiancity_tpu.training.step import Trainer as JTrainer
from gaussiancity_tpu.utils import helpers as jhelpers

from gaussiancity_tpu_torch.testing import tiny_bldg_batch
from test_torch_bldg_training import (_port_trainer, bldg_configs,
                                      check_steps_match_jax, run_jax)

N_PTS = 128
N_MASKED = 32


class _JTrainerBatch(JTrainer):
    """The JAX Trainer's step at B samples on one device (train only)."""

    def _render_fake(self, g_params, batch, feats, crop_size=None,
                     g_stats=None, train=False, dp_rng=None):
        assert train and crop_size is None
        attrs, g_vars = self.generator.apply(
            {"params": g_params, "batch_stats": g_stats},
            feats["proj_uv"], feats["rel_xyz"], None, feats["onehots"],
            feats["z"], batch.get("proj_hf"), batch.get("proj_seg"),
            feats["pts_mask"], True,
            mutable=["intermediates", "batch_stats"],
            rngs={"droppath": dp_rng})
        gs_pts = jhelpers.get_gaussian_points(feats["abs_xyz"],
                                              feats["scales3"], attrs)
        Wc, Hc = self.train_crop_size
        W, H = self.camera.sensor_size
        imgs, outs = [], []
        for b in range(gs_pts.shape[0]):
            cam = self.camera.params_traced(batch["cam_pos"][b],
                                            batch["cam_quat"][b])
            xy = jnp.clip(batch["crp_xy"][b], 0,
                          jnp.asarray([W - Wc, H - Hc]))
            xw = (W - xy[0] - Wc) if self.flip_lr else xy[0]
            yw = (H - xy[1] - Hc) if self.flip_ud else xy[1]
            out = jrasterize_points14(gs_pts[b], cam, self.cfg.rasterizer,
                                      valid=feats["pts_mask"][b],
                                      window=(xw, yw, Wc, Hc))
            img = out.image
            if self.flip_lr:
                img = img[:, :, ::-1]
            if self.flip_ud:
                img = img[:, ::-1, :]
            imgs.append(img.transpose(1, 2, 0))
            outs.append(out)
        overflow = sum(jnp.sum(v) for v in
                       jax.tree_util.tree_leaves(g_vars["intermediates"]))
        diag = {
            "RasterDroppedPairs": sum(o.n_dropped_pairs for o in outs),
            "RasterTruncated": sum(o.n_truncated for o in outs),
            "RasterGradTruncated": sum(o.n_grad_truncated for o in outs),
            "PTv3PoolOverflow": overflow}
        diag = {k: jnp.asarray(v, jnp.float32) for k, v in diag.items()}
        return jnp.stack(imgs), (diag, g_vars["batch_stats"])


def batch2(cfg) -> dict:
    """Two tiny BLDG samples: other points, the second camera moved and
    turned 0.1 rad about the vertical, other crops, and the second
    sample's last ``N_MASKED`` rows masked."""
    one, two = (tiny_bldg_batch(cfg, N_PTS, seed=s) for s in (1, 2))
    batch = {k: np.concatenate([one[k], two[k]]) for k in one}
    batch["pts_mask"][1, N_PTS - N_MASKED:] = False
    batch["cam_pos"][1] = [0.0, 0.4, 0.2]
    batch["cam_quat"][1] = [0.0, 0.0, np.sin(0.05), np.cos(0.05)]
    batch["crp_xy"] = np.array([[16, 8], [100, 24]], np.int32)
    return batch


@pytest.fixture(scope="module")
def jax_run_b2():
    jcfg, cfg = bldg_configs()
    jcfg = jcfg.replace(train=jcfg.train.replace(batch_size=2))
    cfg = cfg.replace(train=cfg.train.replace(batch_size=2))
    return run_jax(jcfg, cfg, batch2(cfg), _JTrainerBatch, with_eval=False)


def test_two_steps_match_jax_pieces(jax_run_b2, monkeypatch):
    """Losses, counters, every G and D gradient, the weights after Adam,
    the spectral-norm state and PTv3's running statistics after each of
    two steps at B = 2, against the reference above.  The two samples'
    images differ, and the masked rows take no gradient."""
    t, batch = _port_trainer(jax_run_b2, monkeypatch)
    grads = {}

    def keep(k, g):  # returns None: the gradient flows on unchanged
        grads.setdefault(k, g)

    def keep_attrs(module, args, out):
        for k, v in out.items():
            if v.requires_grad:
                v.register_hook(lambda g, k=k: keep(k, g))

    handle = t.generator.register_forward_hook(keep_attrs)
    try:
        check_steps_match_jax(t, batch, jax_run_b2["steps"])
    finally:
        handle.remove()
    assert "rgb" in grads
    for k, g in grads.items():
        assert g.shape[:2] == (2, N_PTS), k
        assert float(g[1, N_PTS - N_MASKED:].abs().max()) == 0, k
        assert float(g[:, :N_PTS - N_MASKED].abs().amax((1, 2)).min()) > 0, k
    _, fake = t.eval_step(batch)
    assert not torch.allclose(fake[0], fake[1])
