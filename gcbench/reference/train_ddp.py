"""The reference data-parallel train step: a plain copy of what the port's
``make_parallel_train_step`` (``training/step.py``) makes of one step
over ``n`` ranks, each taking one batch, run here on one device.

Each rank's batch goes through the generator, the rendering, D and the
losses on its own, with its own draws; the gradients are the mean over
the ranks' losses, D's before D's Adam step and G's before G's; the
losses the step returns are the mean over the ranks, as the port's
collectives average them.  D sees the ranks' images as one batch: its
spectral norms take one power step a call whatever the batch, as they
do on each rank.  The generator's running state (BatchNorm statistics)
starts each rank's forward from the same values and is averaged after
the step, as the port averages it over the ranks."""

from __future__ import annotations

from typing import Dict, List

import torch

from gcbench.reference.gct.losses import gan_loss, masked_l1
from gcbench.reference.train import (ReferenceTrainer, _frozen,
                                     _zero_missing_grads)


def _running(module: torch.nn.Module) -> List[torch.Tensor]:
    return [b for b in module.buffers() if b.is_floating_point()]


class ReferenceDataParallel(ReferenceTrainer):
    """``ReferenceTrainer`` whose ``train_step`` takes a list of batches,
    one a rank, and a list of generators, one a rank.  ``last`` holds
    rank 0's Gaussian attributes and crop."""

    def train_step(self, batches: List[dict], rngs: List[torch.Generator]
                   ) -> Dict[str, torch.Tensor]:
        tr = self.cfg.train
        n = len(batches)
        G, D = self.generator, self.discriminator
        G.train()
        start = [b.clone() for b in _running(G)]
        ends, fakes, lasts = [], [], []
        for batch, rng in zip(batches, rngs):
            with torch.no_grad():
                for b, s in zip(_running(G), start):
                    b.copy_(s)
            feats = self._point_features(batch, rng)
            fakes.append(self._render_fake(batch, feats, rng))
            lasts.append(self.last)
            ends.append([b.clone() for b in _running(G)])
        self.last = lasts[0]
        with torch.no_grad():
            for k, b in enumerate(_running(G)):
                b.copy_(torch.stack([e[k] for e in ends]).sum(0) / n)

        def cat(key):
            return torch.cat([b[key] for b in batches])

        rgb, seg, msk = cat("rgb"), cat("seg"), cat("msk")
        gan_w = msk[:, ::4, ::4, :]
        fake = torch.cat(fakes)

        def per_rank(out, real, dis_update):
            return [gan_loss(out["pred"][r:r + 1], out["label"][r:r + 1],
                             real, gan_w[r:r + 1], dis_update=dis_update)
                    for r in range(n)]

        for group in self.d_opt.param_groups:
            group["lr"] = self.d_learning_rate(self.step)
        self.d_opt.zero_grad(set_to_none=True)
        fake_l = per_rank(D(fake.detach(), seg, msk), False, True)
        real_l = per_rank(D(rgb, seg, msk), True, True)
        loss_d = [f + r for f, r in zip(fake_l, real_l)]
        (sum(loss_d) / n).backward()
        _zero_missing_grads(self.d_opt)
        self.d_opt.step()
        with _frozen(D):
            gan = per_rank(D(fake, seg, msk), True, False)
        l1 = [masked_l1(f, b["rgb"], b["msk"])
              for f, b in zip(fakes, batches)]
        pl = [self.ploss(f * b["msk"], b["rgb"] * b["msk"])
              for f, b in zip(fakes, batches)]
        loss_g = [a * tr.l1_loss_factor + p * tr.perceptual_loss_factor
                  + g * tr.gan_loss_factor for a, p, g in zip(l1, pl, gan)]
        self.g_opt.zero_grad(set_to_none=True)
        (sum(loss_g) / n).backward()
        _zero_missing_grads(self.g_opt)
        self.g_opt.step()
        self.step += 1

        def mean(xs):
            return (sum(x.detach() for x in xs) / n)

        return {"DisLoss": mean(loss_d), "GANLossFake": mean(fake_l),
                "GANLossReal": mean(real_l), "GenLoss": mean(loss_g),
                "L1Loss": mean(l1), "PerceptualLoss": mean(pl),
                "GANLoss": mean(gan)}
