"""The whole frame's share of the card's float32 peak, in %: the
generators' model FLOPs on the sampled frames (``gcbench.work.flops``,
their mean) over the window's time a frame times 67 TFLOP/s."""

from gcbench.work import peaks


def read(ctx):
    f = ctx.work.get("flops_per_unit")
    if not f or ctx.unit_s <= 0:
        return None
    return f / (ctx.unit_s * peaks.FP32_FLOP_PER_S) * 100.0
