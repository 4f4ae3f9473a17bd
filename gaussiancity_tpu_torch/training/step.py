# -*- coding: utf-8 -*-
"""GAN training step (counterpart of ``gaussiancity_tpu/training/step.py``;
upstream core/train.py:30-397).

One step with a shared render, as in the JAX package:

  render:  point features -> generator -> 14-channel Gaussians ->
           rasterize the crop window -> flips            (graph kept)
  D step:  D(fake.detach()), D(real) -> N+1 GAN loss -> Adam, with the
           learning rate d_lr * min(1, k / n_warmup_iters) at the k-th D
           update (k = 0 first, so the first D update has lr 0, as
           optax's schedule count gives)
  G step:  D(fake) (D's parameters frozen: no gradient reaches them) ->
           L1 * 10 + VGG * 10 + GAN * 0.5 -> backward through the render
           -> Adam

Spectral-norm state is updated on all three D applications.  Adam is
``torch.optim.Adam``, whose update equals optax's ``adam``.

``train_step`` puts the generator in training mode (PTv3's BatchNorm on
batch statistics, folded into the running averages once per step by the
one render; drop path on) and ``eval_step`` in eval mode, as the JAX
steps pass ``train=True`` / ``False``.  Every random draw comes from a
``torch.Generator`` on the trainer's device: per step the trainer derives
one for the style-code table and one for the drop-path masks from
(seed, step), as the JAX step splits ``rng_z, rng_dp`` from its key; a
generator the caller passes serves both draws instead.

``network.compute_dtype`` "bfloat16" builds the generator in bf16 and
``train.compute_dtype`` "bfloat16" D and the perceptual loss, as the JAX
``Trainer`` builds them (parameters, Adam and the losses stay float32).

Batch layout (tensors on the trainer's device, NHWC images as in the JAX
package):

  pts [B, N, 9] (abs_xyz 0:3, scale 3, instance 4, rel_xyz 5:8, batch 8),
  pts_mask [B, N], rgb [B, Hc, Wc, 3] in [-1, 1], seg [B, Hc, Wc, n_cls],
  msk [B, Hc, Wc, 1], proj_hf [B, P, P, 1], proj_seg [B, P, P, n_cls],
  optional proj_tlp [B, 2], cam_pos [B, 3], cam_quat [B, 4] (xyzw),
  crp_xy [B, 2] int crop origin (x, y) in the flipped frame.

The JAX step takes B = 1 a device.  The port's step takes any B on one
device, as upstream's training takes a batch: the generator runs the B
samples together (PTv3's BatchNorm statistics span them), each sample is
rendered with its own camera and crop, and the losses average over the
batch.  At B = 1 this is the JAX step.  At B > 1 it is not the JAX
package's batch over B devices, whose BatchNorm sees one sample a
device: it is the JAX package's pieces run at B on one device.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gaussiancity_tpu_torch.camera import CameraModel
from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.device import resolve_device
from gaussiancity_tpu_torch.losses import gan_loss, masked_l1
from gaussiancity_tpu_torch.losses.perceptual import (
    PerceptualLoss, check_vgg_weights, load_vgg19_npz)
from gaussiancity_tpu_torch.models.discriminator import Discriminator
from gaussiancity_tpu_torch.models.generator import Generator
from gaussiancity_tpu_torch.models.layers import compute_dtype
from gaussiancity_tpu_torch.ops.rasterizer import rasterize_points14
from gaussiancity_tpu_torch.utils import helpers

@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """Parameters of ``module`` take no gradient inside the block."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


class Trainer:
    """Owns the generator, discriminator, perceptual loss, both Adams and
    the step count, on ``device`` (the card unless the caller asks for the
    CPU).  Weights are drawn from ``torch.Generator().manual_seed(seed)``;
    ``stage_ms`` collects per-stage wall times when ``time_stages`` is set
    (the device is synchronised at each stage boundary)."""

    def __init__(self, cfg: Config, device=None, seed: int = 0):
        self.cfg = cfg
        self.seed = seed
        ds, tr = cfg.dataset, cfg.train
        dt = compute_dtype(tr.compute_dtype)
        self.device = resolve_device(device)
        vgg_npz = check_vgg_weights(tr.perceptual_loss_factor,
                                    tr.allow_random_vgg)
        gen = torch.Generator().manual_seed(seed)
        self.generator = Generator(cfg.network, n_classes=ds.n_classes,
                                   proj_size=ds.proj_size)
        self.generator.reset_parameters(gen)
        self.use_disc = tr.discriminator.enabled
        self.discriminator = None
        if self.use_disc:
            self.discriminator = Discriminator(
                n_channel_base=cfg.network.dis_n_channel_base,
                n_classes=ds.n_classes, dtype=dt)
            self.discriminator.reset_parameters(gen)
        self.ploss = PerceptualLoss(network=tr.perceptual_loss_model,
                                    layers=tr.perceptual_loss_layers,
                                    weights=tr.perceptual_loss_weights,
                                    dtype=dt)
        self.ploss.model.reset_parameters(gen)
        if vgg_npz is not None:
            load_vgg19_npz(vgg_npz, self.ploss.model)
        for m in (self.generator, self.discriminator, self.ploss):
            if m is not None:
                m.to(self.device)
        self.camera = CameraModel(np.asarray(ds.cam_k).reshape(3, 3),
                                  ds.sensor_size)
        self.flip_lr = True
        self.flip_ud = ds.flip_ud
        self.train_crop_size = ds.train_crop_size  # (W, H)
        self.test_crop_size = ds.test_crop_size
        adam = dict(betas=tuple(tr.betas), eps=tr.eps)
        self.g_opt = torch.optim.Adam(self.generator.parameters(),
                                      lr=tr.generator.lr, **adam)
        self.d_opt = (torch.optim.Adam(self.discriminator.parameters(),
                                       lr=0.0, **adam)
                      if self.use_disc else None)
        self.step = 0
        self.time_stages = False
        self.stage_ms: Dict[str, List[float]] = {}

    # ------------------------------------------------------------------
    # timing
    # ------------------------------------------------------------------

    def _now(self) -> float:
        if self.time_stages and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _record(self, stage: str, t0: float) -> float:
        t1 = self._now()
        if self.time_stages:
            self.stage_ms.setdefault(stage, []).append((t1 - t0) * 1e3)
        return t1

    # ------------------------------------------------------------------
    # forward helpers
    # ------------------------------------------------------------------

    def d_learning_rate(self, k: int) -> float:
        """Learning rate of the k-th D update (0-based): the warm-up
        ramp ``d_lr * min(1, k / n_warmup_iters)``."""
        d = self.cfg.train.discriminator
        return d.lr * min(1.0, k / d.n_warmup_iters)

    def step_generators(self, step: int
                        ) -> Tuple[torch.Generator, torch.Generator]:
        """The generators of step ``step``'s z table and drop-path masks,
        on the trainer's device, seeded from (seed, step)."""
        seeds = np.random.SeedSequence([self.seed, step]).generate_state(
            2, dtype=np.uint64)
        return tuple(torch.Generator(device=self.device).manual_seed(int(s))
                     for s in seeds)

    def _point_features(self, batch, rng: torch.Generator):
        ds = self.cfg.dataset
        pts = batch["pts"]
        abs_xyz = pts[..., 0:3]
        rel_xyz = pts[..., 5:8]
        instances = pts[..., 4]
        classes = helpers.instances_to_classes(
            instances, ds.bldg_range, ds.bldg_facade_clsid,
            ds.bldg_roof_clsid, ds.car_range, ds.car_clsid)
        scales = pts[..., 3:4] * self.cfg.network.scale_factor
        scales3 = helpers.get_point_scales(scales, classes,
                                           ds.z_scale_special_classes)
        return dict(
            abs_xyz=abs_xyz, rel_xyz=rel_xyz, scales3=scales3,
            onehots=helpers.get_one_hot(classes, ds.n_classes),
            z=helpers.get_z(rng, instances, self.cfg.network.z_dim),
            proj_uv=helpers.get_projection_uv(abs_xyz, batch.get("proj_tlp"),
                                              ds.proj_size),
            pts_mask=batch.get("pts_mask"))

    def _render_fake(self, batch, feats, crop_size=None,
                     dp_generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Generator -> 14-channel Gaussians -> rasterize each sample's
        crop window with its camera -> flips.  Returns ([B, Hc, Wc, 3]
        NHWC, the rasterizer counters summed over the samples and PTv3's
        overflow count, 0 without PTv3)."""
        t0 = self._now()
        attrs = self.generator(
            feats["proj_uv"], feats["rel_xyz"], None, feats["onehots"],
            feats["z"], batch.get("proj_hf"), batch.get("proj_seg"),
            feats["pts_mask"], dp_generator=dp_generator)
        overflow = (self.generator.pt_net.overflow
                    if self.cfg.network.ptv3.enabled else
                    torch.zeros((), dtype=torch.int64, device=self.device))
        gs_pts = helpers.get_gaussian_points(feats["abs_xyz"],
                                             feats["scales3"], attrs)
        t0 = self._record("generator", t0)
        # render only the crop window; crp_xy addresses the flipped image
        Wc, Hc = crop_size or self.train_crop_size
        W, H = self.camera.sensor_size
        mask = feats["pts_mask"]
        imgs, outs = [], []
        for b in range(gs_pts.shape[0]):
            cam = self.camera.params_f32(batch["cam_pos"][b],
                                         batch["cam_quat"][b])
            x, y = (int(v) for v in batch["crp_xy"][b].tolist())
            x, y = min(max(x, 0), W - Wc), min(max(y, 0), H - Hc)
            xw = W - x - Wc if self.flip_lr else x
            yw = H - y - Hc if self.flip_ud else y
            out = rasterize_points14(
                gs_pts[b], cam, self.cfg.rasterizer,
                valid=mask[b] if mask is not None else None,
                window=(xw, yw, Wc, Hc))
            img = out.image
            if self.flip_lr:
                img = img.flip(-1)
            if self.flip_ud:
                img = img.flip(-2)
            imgs.append(img)
            outs.append(out)
        diag = {"RasterDroppedPairs": sum(o.n_dropped_pairs for o in outs),
                "RasterTruncated": sum(o.n_truncated for o in outs),
                "RasterGradTruncated": sum(o.n_grad_truncated for o in outs),
                "PTv3PoolOverflow": overflow}
        self._record("render", t0)
        # an NHWC view of [B, 3, Hc, Wc] memory: D and VGG permute it back
        # to contiguous NCHW, and their convolutions see that layout
        return torch.stack(imgs).permute(0, 2, 3, 1), diag

    # ------------------------------------------------------------------
    # train / eval
    # ------------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor],
                   rng: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One D + G update.  Returns the metrics as 0-dim tensors on the
        device.  After the step, each parameter's ``.grad`` holds this
        step's gradient (D's from the D loss only).  ``rng``, when given,
        serves the z table and then the drop-path masks; otherwise the
        step's own generators do (``step_generators``)."""
        tr = self.cfg.train
        rng_z, rng_dp = ((rng, rng) if rng is not None
                         else self.step_generators(self.step))
        self.generator.train()
        feats = self._point_features(batch, rng_z)
        gan_w = batch["msk"][:, ::4, ::4, :]  # nearest 0.25x
        fake, metrics = self._render_fake(batch, feats, dp_generator=rng_dp)
        t0 = self._now()
        if self.use_disc:
            D = self.discriminator
            for group in self.d_opt.param_groups:
                group["lr"] = self.d_learning_rate(self.step)
            self.d_opt.zero_grad(set_to_none=True)
            fake_out = D(fake.detach(), batch["seg"], batch["msk"])
            real_out = D(batch["rgb"], batch["seg"], batch["msk"])
            fake_l = gan_loss(fake_out["pred"], fake_out["label"], False,
                              gan_w, dis_update=True)
            real_l = gan_loss(real_out["pred"], real_out["label"], True,
                              gan_w, dis_update=True)
            loss_d = fake_l + real_l
            loss_d.backward()
            self.d_opt.step()
            metrics.update(DisLoss=loss_d.detach(), GANLossFake=fake_l.detach(),
                           GANLossReal=real_l.detach())
        else:
            zero = fake.new_zeros(())
            metrics.update(DisLoss=zero, GANLossFake=zero, GANLossReal=zero)
        t0 = self._record("d_step", t0)

        if self.use_disc:
            with _frozen(self.discriminator):
                out = self.discriminator(fake, batch["seg"], batch["msk"])
            gan = gan_loss(out["pred"], out["label"], True, gan_w,
                           dis_update=False)
        else:
            gan = fake.new_zeros(())
        l1 = masked_l1(fake, batch["rgb"], batch["msk"])
        pl = self.ploss(fake * batch["msk"], batch["rgb"] * batch["msk"])
        loss_g = (l1 * tr.l1_loss_factor + pl * tr.perceptual_loss_factor
                  + gan * tr.gan_loss_factor)
        t0 = self._record("g_loss", t0)
        self.g_opt.zero_grad(set_to_none=True)
        loss_g.backward()
        t0 = self._record("backward", t0)
        self.g_opt.step()
        self._record("adam", t0)
        self.step += 1
        metrics.update(GenLoss=loss_g.detach(), L1Loss=l1.detach(),
                       PerceptualLoss=pl.detach(), GANLoss=gan.detach())
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor],
                  rng: Optional[torch.Generator] = None
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Render the test crop in eval mode (PTv3 on its running
        statistics, no drop path) and its masked L1: (metrics, fake NHWC).
        The z table comes from ``rng`` or from the step's generator."""
        self.generator.eval()
        rng = rng if rng is not None else self.step_generators(self.step)[0]
        feats = self._point_features(batch, rng)
        fake, diag = self._render_fake(batch, feats,
                                       crop_size=self.test_crop_size)
        l1 = masked_l1(fake, batch["rgb"], batch["msk"])
        return {"L1Loss": l1, **diag}, fake

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def state_dict(self) -> Dict:
        """G and D weights with the spectral-norm buffers, both Adam
        states, the step and the VGG weights (the JAX package's train
        state carries them too)."""
        return {
            "step": self.step,
            "ploss": self.ploss.state_dict(),
            "generator": self.generator.state_dict(),
            "g_opt": self.g_opt.state_dict(),
            "discriminator": (self.discriminator.state_dict()
                              if self.use_disc else None),
            "d_opt": self.d_opt.state_dict() if self.use_disc else None,
        }

    def load_state_dict(self, state: Dict) -> None:
        self.step = int(state["step"])
        self.ploss.load_state_dict(state["ploss"])
        self.generator.load_state_dict(state["generator"])
        self.g_opt.load_state_dict(state["g_opt"])
        if self.use_disc:
            self.discriminator.load_state_dict(state["discriminator"])
            self.d_opt.load_state_dict(state["d_opt"])


def make_train_step(trainer: Trainer):
    """The step as a function of (batch, rng).  The port runs eagerly:
    there is nothing to compile."""

    def step(batch, rng: Optional[torch.Generator] = None):
        return trainer.train_step(batch, rng)

    return step
