"""Device time of the NCCL kernels of a data-parallel train step without
the wait for the slowest rank (the all-reduces of D's and G's gradients
and of the running state and metrics), ms a step: each collective's
shortest kernel over every rank's profiled pass, summed
(``gcbench.work.allreduce``)."""

from gcbench.work import allreduce


def read(ctx):
    p = ctx.profile
    if p is None or p.n <= 0:
        return None
    t = allreduce.transfer_ns(ctx.ranks or [p])
    return t * 1e-6 / p.n if t else None
