"""PTv3's backward in a train step: CUDA events from the gradient of
``PointTransformerV3``'s output to the last of its parameters' gradients
(``gcbench.probes.BackwardSpan``), ms a step."""

from gcbench import probes

CLASS = "PointTransformerV3"


def install(ctx):
    return probes.Group([probes.BackwardSpan(m) for m in
                         probes.modules_named(ctx.modules(), CLASS)])


def read(ctx):
    g = ctx.hooks.get("ptv3.bwd_ms.train")
    if g is None or not g.spans():
        return None
    return g.ms() / ctx.n_traced
