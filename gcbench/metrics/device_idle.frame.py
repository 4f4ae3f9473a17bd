"""The share of the frames in which no work ran on the device, in %: the
union of the profiled frames' kernels, copies and fills (``gcbench.trace``)
over their number times the window's time a frame, measured before the
profiler was on (the profiler's own host cost stretches its pass)."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.device or p.n <= 0 or ctx.unit_s <= 0:
        return None
    return (1.0 - p.busy_s() / (p.n * ctx.unit_s)) * 100.0
