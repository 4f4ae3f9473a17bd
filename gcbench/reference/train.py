"""The reference train step: a frozen plain copy of the port's
``Trainer.train_step`` (``training/step.py``) on the reference's own
generator, discriminator, perceptual loss and rasterizer, with
``torch.optim.Adam`` as the port uses it and no stage timing.

The weights come from ``gcbench.weights``, the same the benchmark loads
into the program; the step's random draws (style codes, drop-path masks)
come from the generator the caller passes, as the program's do."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch

from gcbench.reference.gct.camera import CameraModel
from gcbench.reference.gct.losses import gan_loss, masked_l1
from gcbench.reference.gct.ops.rasterizer import rasterize_points14
from gcbench.reference.gct.utils import helpers


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(module.parameters(), flags):
            p.requires_grad_(f)


def _zero_missing_grads(opt: torch.optim.Optimizer) -> None:
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


class ReferenceTrainer:
    """Generator, discriminator, perceptual loss and both Adams of
    ``models`` (``gcbench.weights.train_models``).  ``last`` holds the
    latest step's Gaussian attributes and rendered crop."""

    def __init__(self, cfg, models: Dict[str, torch.nn.Module]):
        self.cfg = cfg
        ds, tr = cfg.dataset, cfg.train
        self.generator = models["generator"]
        self.discriminator = models["discriminator"]
        self.ploss = models["ploss"]
        self.camera = CameraModel(np.asarray(ds.cam_k).reshape(3, 3),
                                  ds.sensor_size)
        self.flip_ud = ds.flip_ud
        self.train_crop_size = ds.train_crop_size
        adam = dict(betas=tuple(tr.betas), eps=tr.eps)
        self.g_opt = torch.optim.Adam(self.generator.parameters(),
                                      lr=tr.generator.lr, **adam)
        self.d_opt = torch.optim.Adam(self.discriminator.parameters(),
                                      lr=0.0, **adam)
        self.step = 0
        self.last: Dict[str, object] = {}

    def d_learning_rate(self, k: int) -> float:
        d = self.cfg.train.discriminator
        return d.lr * min(1.0, k / d.n_warmup_iters)

    def _point_features(self, batch, rng: torch.Generator):
        ds = self.cfg.dataset
        pts = batch["pts"]
        abs_xyz = pts[..., 0:3]
        instances = pts[..., 4]
        classes = helpers.instances_to_classes(
            instances, ds.bldg_range, ds.bldg_facade_clsid,
            ds.bldg_roof_clsid, ds.car_range, ds.car_clsid)
        scales = pts[..., 3:4] * self.cfg.network.scale_factor
        return dict(
            abs_xyz=abs_xyz, rel_xyz=pts[..., 5:8],
            scales3=helpers.get_point_scales(scales, classes,
                                             ds.z_scale_special_classes),
            onehots=helpers.get_one_hot(classes, ds.n_classes),
            z=helpers.get_z(rng, instances, self.cfg.network.z_dim),
            proj_uv=helpers.get_projection_uv(abs_xyz, batch.get("proj_tlp"),
                                              ds.proj_size),
            pts_mask=batch.get("pts_mask"))

    def _render_fake(self, batch, feats, rng):
        attrs = self.generator(
            feats["proj_uv"], feats["rel_xyz"], None, feats["onehots"],
            feats["z"], batch.get("proj_hf"), batch.get("proj_seg"),
            feats["pts_mask"], dp_generator=rng)
        gs_pts = helpers.get_gaussian_points(feats["abs_xyz"],
                                             feats["scales3"], attrs)
        Wc, Hc = self.train_crop_size
        W, H = self.camera.sensor_size
        mask = feats["pts_mask"]
        imgs = []
        for b in range(gs_pts.shape[0]):
            cam = self.camera.params_f32(batch["cam_pos"][b],
                                         batch["cam_quat"][b])
            x, y = (int(v) for v in batch["crp_xy"][b].tolist())
            x, y = min(max(x, 0), W - Wc), min(max(y, 0), H - Hc)
            xw = W - x - Wc
            yw = H - y - Hc if self.flip_ud else y
            img = rasterize_points14(gs_pts[b], cam, self.cfg.rasterizer,
                                     valid=mask[b], window=(xw, yw, Wc, Hc)
                                     ).image.flip(-1)
            if self.flip_ud:
                img = img.flip(-2)
            imgs.append(img)
        fake = torch.stack(imgs).permute(0, 2, 3, 1)
        self.last = {"attrs": {k: v.detach() for k, v in attrs.items()},
                     "fake": fake.detach()}
        return fake

    def train_step(self, batch, rng: Optional[torch.Generator]
                   ) -> Dict[str, torch.Tensor]:
        tr = self.cfg.train
        self.generator.train()
        feats = self._point_features(batch, rng)
        gan_w = batch["msk"][:, ::4, ::4, :]
        fake = self._render_fake(batch, feats, rng)
        D = self.discriminator
        for group in self.d_opt.param_groups:
            group["lr"] = self.d_learning_rate(self.step)
        self.d_opt.zero_grad(set_to_none=True)
        fake_out = D(fake.detach(), batch["seg"], batch["msk"])
        real_out = D(batch["rgb"], batch["seg"], batch["msk"])
        fake_l = gan_loss(fake_out["pred"], fake_out["label"], False, gan_w,
                          dis_update=True)
        real_l = gan_loss(real_out["pred"], real_out["label"], True, gan_w,
                          dis_update=True)
        loss_d = fake_l + real_l
        loss_d.backward()
        _zero_missing_grads(self.d_opt)
        self.d_opt.step()
        with _frozen(D):
            out = D(fake, batch["seg"], batch["msk"])
        gan = gan_loss(out["pred"], out["label"], True, gan_w,
                       dis_update=False)
        l1 = masked_l1(fake, batch["rgb"], batch["msk"])
        pl = self.ploss(fake * batch["msk"], batch["rgb"] * batch["msk"])
        loss_g = (l1 * tr.l1_loss_factor + pl * tr.perceptual_loss_factor
                  + gan * tr.gan_loss_factor)
        self.g_opt.zero_grad(set_to_none=True)
        loss_g.backward()
        _zero_missing_grads(self.g_opt)
        self.g_opt.step()
        self.step += 1
        return {"DisLoss": loss_d.detach(), "GANLossFake": fake_l.detach(),
                "GANLossReal": real_l.detach(), "GenLoss": loss_g.detach(),
                "L1Loss": l1.detach(), "PerceptualLoss": pl.detach(),
                "GANLoss": gan.detach()}
