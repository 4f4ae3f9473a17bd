"""The part of the NCCL kernels' time of a data-parallel train step on
rank 0 during which no other kernel, copy or fill ran on its card, ms a
step (``gcbench.work.allreduce``): the all-reduce time, waits included,
that no computation hides."""

from gcbench.work import allreduce


def read(ctx):
    p = ctx.profile
    if p is None or p.n <= 0 or not allreduce.collectives(p):
        return None
    return allreduce.exposed_ns(p) * 1e-6 / p.n
