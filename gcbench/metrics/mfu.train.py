"""The whole train step's share of the card's float32 peak, in %: the
step's model FLOPs (``gcbench.work.flops``: generator forward and
backward, D on both images and its backward in the D step, D forward and
backward in the G step, VGG on both images and its backward through the
fake) over the window's time a step times 67 TFLOP/s."""

from gcbench.work import peaks


def read(ctx):
    f = ctx.work.get("flops_per_unit")
    if not f or ctx.unit_s <= 0:
        return None
    return f / (ctx.unit_s * peaks.FP32_FLOP_PER_S) * 100.0
