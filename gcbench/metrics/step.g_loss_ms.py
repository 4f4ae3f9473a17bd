"""The generator's losses in a train step: D on the fake, L1 and the VGG
perceptual loss (``Trainer.stage_ms["g_loss"]`` with ``time_stages``
on), mean over the instrumented steps, in ms."""

import statistics


def read(ctx):
    v = ctx.stage_ms.get("g_loss")
    return statistics.fmean(v) if v else None
