"""PTv3's forward in a frame: CUDA events in forward pre- and post-hooks
on ``PointTransformerV3`` (``gcbench.probes.ForwardSpan``), ms a frame."""

from gcbench import probes

CLASS = "PointTransformerV3"


def install(ctx):
    return probes.Group([probes.ForwardSpan(m) for m in
                         probes.modules_named(ctx.modules(), CLASS)])


def read(ctx):
    g = ctx.hooks.get("ptv3.fwd_ms.frame")
    if g is None or not g.spans():
        return None
    return g.ms() / ctx.n_traced
