"""Host stage of the frame: the visible points copied to the host,
normalised per instance and split by class (``InferencePipeline.
stage_ms["points"]``, the pipeline synchronising at each stage
boundary), mean over the window's frames, in ms."""

import statistics


def read(ctx):
    v = ctx.stage_ms.get("points")
    return statistics.fmean(v) if v else None
