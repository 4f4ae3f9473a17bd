"""The generators of a frame (``InferencePipeline.stage_ms["generator"]``,
which spans every model's ``generator_<name>`` stage), mean over the
window's frames, in ms."""

import statistics


def read(ctx):
    v = ctx.stage_ms.get("generator")
    return statistics.fmean(v) if v else None
