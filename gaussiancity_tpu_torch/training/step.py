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
device: it is the JAX package's pieces run at B on one device.  The JAX
package's batch over devices is ``make_parallel_train_step``: one process
a rank, each with B samples of its own.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
from gaussiancity_tpu_torch.utils import helpers, profiling

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
    (the device is synchronised at each stage boundary;
    ``utils.profiling.Stages``)."""

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
        self.stages = profiling.Stages(self.device)
        self.stage_ms: Dict[str, List[float]] = self.stages.ms

    @property
    def time_stages(self) -> bool:
        return self.stages.timed

    @time_stages.setter
    def time_stages(self, on: bool) -> None:
        self.stages.timed = bool(on)

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
        self.stages.restart()
        with self.stages("generator"):
            attrs = self.generator(
                feats["proj_uv"], feats["rel_xyz"], None, feats["onehots"],
                feats["z"], batch.get("proj_hf"), batch.get("proj_seg"),
                feats["pts_mask"], dp_generator=dp_generator)
            overflow = (self.generator.pt_net.overflow
                        if self.cfg.network.ptv3.enabled else
                        torch.zeros((), dtype=torch.int64,
                                    device=self.device))
            gs_pts = helpers.get_gaussian_points(feats["abs_xyz"],
                                                 feats["scales3"], attrs)
        # render only the crop window; crp_xy addresses the flipped image
        Wc, Hc = crop_size or self.train_crop_size
        W, H = self.camera.sensor_size
        mask = feats["pts_mask"]
        imgs, outs = [], []
        with self.stages("render"):
            for b in range(gs_pts.shape[0]):
                cam = self.camera.params_f32(batch["cam_pos"][b],
                                             batch["cam_quat"][b])
                with profiling.span("sync.crop_origin"):
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
            diag = {"RasterDroppedPairs": sum(o.n_dropped_pairs
                                              for o in outs),
                    "RasterTruncated": sum(o.n_truncated for o in outs),
                    "RasterGradTruncated": sum(o.n_grad_truncated
                                               for o in outs),
                    "PTv3PoolOverflow": overflow}
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
        with profiling.step_annotation("train_step", self.step):
            return self._train_step(batch, rng)

    def _train_step(self, batch, rng):
        tr = self.cfg.train
        rng_z, rng_dp = ((rng, rng) if rng is not None
                         else self.step_generators(self.step))
        self.generator.train()
        feats = self._point_features(batch, rng_z)
        gan_w = batch["msk"][:, ::4, ::4, :]  # nearest 0.25x
        fake, metrics = self._render_fake(batch, feats, dp_generator=rng_dp)
        self.stages.restart()
        with self.stages("d_step"):
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
                _zero_missing_grads(self.d_opt)
                with profiling.span("adam_d"):
                    self.d_opt.step()
                metrics.update(DisLoss=loss_d.detach(),
                               GANLossFake=fake_l.detach(),
                               GANLossReal=real_l.detach())
            else:
                zero = fake.new_zeros(())
                metrics.update(DisLoss=zero, GANLossFake=zero,
                               GANLossReal=zero)

        with self.stages("g_loss"):
            if self.use_disc:
                with _frozen(self.discriminator):
                    out = self.discriminator(fake, batch["seg"],
                                             batch["msk"])
                gan = gan_loss(out["pred"], out["label"], True, gan_w,
                               dis_update=False)
            else:
                gan = fake.new_zeros(())
            l1 = masked_l1(fake, batch["rgb"], batch["msk"])
            pl = self.ploss(fake * batch["msk"], batch["rgb"] * batch["msk"])
            loss_g = (l1 * tr.l1_loss_factor
                      + pl * tr.perceptual_loss_factor
                      + gan * tr.gan_loss_factor)
        with self.stages("backward"):
            self.g_opt.zero_grad(set_to_none=True)
            loss_g.backward()
        with self.stages("adam"):
            _zero_missing_grads(self.g_opt)
            with profiling.span("adam_g"):
                self.g_opt.step()
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


def _zero_missing_grads(opt: torch.optim.Optimizer) -> None:
    """Give every parameter that autograd left without a gradient a zero
    one, so that Adam steps it as optax does: its moments decay and it
    moves by them (``torch.optim.Adam`` skips a ``None`` gradient)."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_train_step(trainer: Trainer):
    """The step as a function of (batch, rng).  The port runs eagerly:
    there is nothing to compile."""

    def step(batch, rng: Optional[torch.Generator] = None):
        return trainer.train_step(batch, rng)

    return step


def _flat(tensors: List[torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


class DataParallelSync:
    """The collectives of one rank's share of a data-parallel step over
    ``group`` (the default group when None).  Every average is a sum over
    the ranks divided by the world size, as ``jax.lax.pmean`` takes it,
    over one flat float32 buffer a call, so that each call is one
    ``all_reduce``."""

    def __init__(self, group=None):
        self.group = group
        self.world = dist.get_world_size(group)

    def _mean_(self, flat: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(flat, group=self.group)
        return flat.div_(self.world)

    def gradients(self, module: torch.nn.Module) -> None:
        """Average ``module``'s gradients over the ranks, in parameter
        order.  ``Trainer.train_step`` has given every parameter a
        gradient (zeros where autograd skipped it, as JAX's gradients are),
        so every rank sends a buffer of the same size."""
        params = list(module.parameters())
        flat = self._mean_(_flat([p.grad for p in params]))
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad = g.view_as(p).to(p.dtype)

    def state(self, trainer: Trainer, metrics: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """Average the running state (D's spectral-norm ``u`` and
        ``sigma``, the generator's BatchNorm running statistics) and the
        metrics, counters included, in one collective.  Returns the
        averaged metrics as float32 0-dim tensors."""
        bufs = running_state(trainer)
        names = list(metrics)
        vals = torch.stack([metrics[k].detach().float() for k in names])
        flat = self._mean_(torch.cat([_flat(bufs), vals.to(trainer.device)]))
        parts = flat.split([b.numel() for b in bufs] + [len(names)])
        with torch.no_grad():
            for b, v in zip(bufs, parts):
                b.copy_(v.view_as(b))
        return dict(zip(names, parts[-1].unbind()))


def running_state(trainer: Trainer) -> List[torch.Tensor]:
    """The state a step changes besides the weights and Adam's: every
    floating buffer of the discriminator (its spectral-norm ``u`` and
    ``sigma``) and of the generator (PTv3's BatchNorm ``mean`` and
    ``var``), the JAX ``TrainState``'s ``d_stats`` and ``g_stats``."""
    modules = [trainer.generator] + ([trainer.discriminator]
                                     if trainer.use_disc else [])
    return [b for m in modules for b in m.buffers()
            if b.is_floating_point()]


def broadcast_state(trainer: Trainer, group=None, src: int = 0) -> None:
    """Copy rank ``src``'s parameters, buffers and both Adam states to
    every rank of ``group``, one broadcast per dtype, as the JAX loop
    replicates one host state over its devices.  The ranks must hold the
    same set of tensors (the same config, and the same checkpoint or
    none); a rank that does not raises before the broadcast."""
    tensors = []
    for m in (trainer.generator, trainer.discriminator, trainer.ploss):
        if m is not None:
            tensors += list(m.parameters()) + list(m.buffers())
    for opt in (trainer.g_opt, trainer.d_opt):
        if opt is None:
            continue
        for group_ in opt.param_groups:
            for p in group_["params"]:
                st = opt.state.get(p, {})
                tensors += [st[k] for k in sorted(st)
                            if torch.is_tensor(st[k])]
    src_global = (dist.get_global_rank(group, src) if group is not None
                  else src)
    sizes = torch.tensor([len(tensors), sum(t.numel() for t in tensors)],
                         device=trainer.device)
    want = sizes.clone()
    dist.broadcast(want, src_global, group=group)
    if not torch.equal(sizes, want):
        raise RuntimeError(f"this rank holds {sizes.tolist()} state "
                           f"tensors / elements, rank {src} "
                           f"{want.tolist()}: the ranks' states differ")
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        part = [t for t in tensors if t.dtype == dtype]
        flat = _flat(part, dtype).to(trainer.device)
        dist.broadcast(flat, src_global, group=group)
        with torch.no_grad():
            for t, v in zip(part, flat.split([t.numel() for t in part])):
                t.copy_(v.view_as(t))


def rank_generator(trainer: Trainer, step: int, rank: int
                   ) -> torch.Generator:
    """Rank ``rank``'s generator of step ``step`` of a data-parallel run,
    on the trainer's device, seeded from (seed, step, rank).  It serves the
    rank's z table and then its drop-path masks (``Trainer.train_step``'s
    ``rng``)."""
    (seed,) = np.random.SeedSequence([trainer.seed, step, rank]
                                     ).generate_state(1, dtype=np.uint64)
    return torch.Generator(device=trainer.device).manual_seed(int(seed))


def make_parallel_train_step(trainer: Trainer, group=None):
    """The data-parallel train step over ``group`` (the default group when
    None), counterpart of the JAX ``make_parallel_train_step`` and of
    upstream's DDP step: each process is one rank with its own ``trainer``
    on its own device, and ``step(batch)`` takes that rank's batch.

    - Each rank runs ``cfg.train.batch_size`` samples of its own exactly
      as ``Trainer.train_step`` runs them on one device.  PTv3's BatchNorm
      normalises each rank's samples by their own statistics (no
      SyncBatchNorm: the JAX package's BatchNorm reduces over its vmap
      axis, never over devices).
    - D's and G's gradients are averaged over the ranks right before each
      Adam update, by step pre-hooks that this installs on the trainer's
      two optimizers; after the step the spectral-norm state, the
      BatchNorm running averages and the metrics are averaged, so that
      the replicas stay bit-equal (``DataParallelSync``).
    - Rank r draws its z table and drop-path masks from (seed, step, r)
      (``rank_generator``), as the JAX step folds the device index into
      its key.  At world size 1 the trainer's own stream serves, and the
      step equals ``Trainer.train_step`` bit for bit.

    With ``trainer.time_stages`` on, the collectives are a stage of their
    own, ``allreduce``, taken out of the stages that hold them (``d_step``
    and ``adam``).  Building the step broadcasts rank 0's state
    (``broadcast_state``): build it after a resume, once per trainer."""
    broadcast_state(trainer, group)
    sync = DataParallelSync(group)
    rank = dist.get_rank(group) if sync.world > 1 else None
    stages = trainer.stages
    held: List[str] = []  # the stages whose collectives were timed

    def averaging(module: torch.nn.Module, stage: str):
        def hook(optimizer, args, kwargs):
            stages.restart()
            with stages("allreduce"):
                sync.gradients(module)
            if stages.timed:
                held.append(stage)
        return hook

    trainer.g_opt.register_step_pre_hook(averaging(trainer.generator, "adam"))
    if trainer.use_disc:
        trainer.d_opt.register_step_pre_hook(
            averaging(trainer.discriminator, "d_step"))

    def step(batch, rng=None):
        if rng is None and rank is not None:
            rng = rank_generator(trainer, trainer.step, rank)
        held.clear()
        metrics = trainer.train_step(batch, rng)
        stages.restart()
        with stages("allreduce"):
            metrics = sync.state(trainer, metrics)
        if stages.timed:
            # one allreduce entry a step: the hooks' collectives, taken
            # out of the stages that held them, and the state's
            ms = stages.ms["allreduce"]
            parts = ms[-len(held) - 1:]
            del ms[-len(held) - 1:]
            for stage, t in zip(held, parts):
                stages.ms[stage][-1] -= t
            ms.append(sum(parts))
        return metrics

    return step
