"""The ranks' skew at a data-parallel train step's all-reduces, ms a
step: each collective's longest NCCL kernel over every rank's profiled
pass less its shortest, summed (``gcbench.work.allreduce``).  What the
first rank to arrive waits for the last."""

from gcbench.work import allreduce


def read(ctx):
    p = ctx.profile
    if p is None or p.n <= 0 or len(ctx.ranks) < 2:
        return None
    t = allreduce.skew_ns(ctx.ranks)
    return None if t is None else t * 1e-6 / p.n
