"""Device kernels a frame: the profiled pass's device events that are
neither a copy nor a fill, over its frames (``gcbench.spans``).  Counted
on the device, so the hand kernels' launches count too; read only where
the program marks its frames with ``gct/`` spans."""

from gcbench import spans


def read(ctx):
    return None if ctx.profile is None else spans.kernels(ctx.profile)
