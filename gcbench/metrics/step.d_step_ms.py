"""The discriminator's update in a train step (``Trainer.stage_ms
["d_step"]`` with ``time_stages`` on), mean over the instrumented steps,
in ms."""

import statistics


def read(ctx):
    v = ctx.stage_ms.get("d_step")
    return statistics.fmean(v) if v else None
