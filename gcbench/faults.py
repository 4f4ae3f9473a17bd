"""Faults planted in the program's timed path, for the harness's tests
(on the CPU, at tiny sizes) and for ``control.py --mode fault-<name>``
(on the chip, at the cell's size): each must make ``correct`` false.

``patch(obj, name, value)`` replaces an attribute (pytest's
``monkeypatch.setattr`` or ``Patcher.setattr``).  A cell whose ranks run
in processes of their own plants there the fault that ``ENV`` names
(``plant_named``); the benchmark's own runs never set it."""

from __future__ import annotations

import os

ENV = "GCBENCH_FAULT"


def unchanged(patch) -> None:
    """The train step runs but returns its state as it found it."""
    from gaussiancity_tpu_torch.training.step import Trainer

    orig = Trainer.train_step

    def step(self, batch, rng=None):
        mods = [self.generator, self.discriminator]
        keep = [{k: v.clone() for k, v in m.state_dict().items()}
                for m in mods]
        out = orig(self, batch, rng)
        for m, s in zip(mods, keep):
            m.load_state_dict(s)
        return out

    patch(Trainer, "train_step", step)


def half_points(patch) -> None:
    """Half of the sample's points left out of the train step (a cell of
    one sample a step has no half batch to leave out)."""
    from gaussiancity_tpu_torch.training.step import Trainer

    orig = Trainer.train_step

    def step(self, batch, rng=None):
        b = dict(batch)
        m = b["pts_mask"].clone()
        m[:, ::2] = False
        b["pts_mask"] = m
        return orig(self, b, rng)

    patch(Trainer, "train_step", step)


def altered_crop(patch) -> None:
    """The rendered crop altered where it is produced."""
    from gaussiancity_tpu_torch.training.step import Trainer

    orig = Trainer._render_fake

    def render(self, *a, **kw):
        fake, diag = orig(self, *a, **kw)
        return fake + 0.05, diag

    patch(Trainer, "_render_fake", render)


def d_unstepped(patch) -> None:
    """D's Adam step left out: D's weights and moments as they were."""
    from gaussiancity_tpu_torch.training.step import Trainer

    orig = Trainer.train_step

    def step(self, batch, rng=None):
        self.d_opt.step = lambda *a, **kw: None
        try:
            return orig(self, batch, rng)
        finally:
            del self.d_opt.step

    patch(Trainer, "train_step", step)


def d_no_warmup(patch) -> None:
    """D's Adam applies its full learning rate from the first update, its
    warm-up ramp left out."""
    from gaussiancity_tpu_torch.training.step import Trainer

    patch(Trainer, "d_learning_rate",
          lambda self, k: self.cfg.train.discriminator.lr)


def d_beta2(patch) -> None:
    """D's Adam keeps its second moment with ten times the configured
    1 - beta2; G's Adam and every weight D's warm-up moves are as
    configured."""
    from gaussiancity_tpu_torch.training.step import Trainer

    orig = Trainer.train_step

    def step(self, batch, rng=None):
        for g in self.d_opt.param_groups:
            b1, b2 = self.cfg.train.betas
            g["betas"] = (b1, 1.0 - 10.0 * (1.0 - b2))
        return orig(self, batch, rng)

    patch(Trainer, "train_step", step)


def altered_frame(patch) -> None:
    """A block of the frame altered where it is produced."""
    from gaussiancity_tpu_torch.inference import pipeline

    orig = pipeline.frame_to_uint8

    def to_uint8(img):
        f = orig(img)
        f[: f.shape[0] // 4, : f.shape[1] // 4] ^= 0x10
        return f

    patch(pipeline, "frame_to_uint8", to_uint8)


def _sync():
    from gaussiancity_tpu_torch.training.step import DataParallelSync

    return DataParallelSync


def skip_average(patch) -> None:
    """The last rank joins the gradients' all-reduce but steps with its
    own gradients, not the average."""
    sync = _sync()
    orig = sync.gradients

    def gradients(self, module):
        import torch.distributed as dist

        own = [p.grad.clone() for p in module.parameters()]
        orig(self, module)
        if dist.get_rank(self.group) == self.world - 1:
            for p, g in zip(module.parameters(), own):
                p.grad = g

    patch(sync, "gradients", gradients)


def sum_not_mean(patch) -> None:
    """The gradients' all-reduce sum is not divided by the world size."""
    sync = _sync()
    orig = sync.gradients

    def gradients(self, module):
        orig(self, module)
        for p in module.parameters():
            p.grad.mul_(self.world)

    patch(sync, "gradients", gradients)


def half_batch(patch) -> None:
    """The upper half of the ranks' gradients left out of the all-reduce,
    the mean taken over the rest."""
    sync = _sync()
    orig = sync.gradients

    def gradients(self, module):
        import torch.distributed as dist

        if dist.get_rank(self.group) >= self.world // 2:
            for p in module.parameters():
                p.grad.zero_()
        orig(self, module)
        for p in module.parameters():
            p.grad.mul_(self.world / (self.world // 2))

    patch(sync, "gradients", gradients)


def no_exchange(patch) -> None:
    """The gradients' exchange between the ranks left out: each rank
    steps with its own."""
    patch(_sync(), "gradients", lambda self, module: None)


TRAIN = {"unchanged": unchanged, "half_points": half_points,
         "altered_crop": altered_crop, "d_unstepped": d_unstepped,
         "d_no_warmup": d_no_warmup, "d_beta2": d_beta2}
FRAME = {"altered_frame": altered_frame}
DDP = {"skip_average": skip_average, "sum_not_mean": sum_not_mean,
       "half_batch": half_batch, "no_exchange": no_exchange}
ALL = {**TRAIN, **FRAME, **DDP}


def plant_named(patch) -> None:
    """Plant the fault that the environment's ``ENV`` names, if any."""
    name = os.environ.get(ENV)
    if name:
        ALL[name](patch)


class Patcher:
    """``setattr`` that ``undo`` reverts."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value) -> None:
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved = []
