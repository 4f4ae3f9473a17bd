"""The SubMConv modules' share of their roofline in a train step, in %:
the least time for their forward and backward over their device time
between the hooks on each ``SubMConv`` (forward spans and backward
spans, ``gcbench.probes``).

The work is the benchmark's count on the reference for the same samples
(``gcbench.work.flops.SubMConvCall``): operations 2 x pairs x C_in x
C_out forward and twice that backward, over the neighbour pairs that
exist; bytes the features in and out, the weights and the neighbour
table once each, forward and backward.  The bound is the larger of
operations over the float32 peak and bytes over HBM's."""

import sys

from gcbench import probes
from gcbench.work import peaks

CLASS = "SubMConv"


def install(ctx):
    mods = probes.modules_named(ctx.modules(), CLASS)
    return probes.Group([probes.ForwardSpan(m) for m in mods]
                        + [probes.BackwardSpan(m) for m in mods])


def read(ctx):
    g = ctx.hooks.get("roofline.submconv.train")
    w = ctx.work.get("submconv")
    if g is None or not g.spans() or not w or not w["calls"]:
        return None
    ms = g.ms() / ctx.n_traced
    bound, by = peaks.bound_s(w["flops"] / ctx.work["units"],
                              w["bytes"] / ctx.work["units"])
    print(f"roofline.submconv.train: bound by {by}, {bound * 1e3:.4f} ms "
          f"of {ms:.4f} ms a step", file=sys.stderr)
    return bound * 1e3 / ms * 100.0
