"""Bus bandwidth of a data-parallel train step's all-reduces, GB/s: 2 (n
- 1) / n times the float32 bytes all-reduced a step (both models'
gradients, their floating buffers and the metrics, counted by the kind)
over the collectives' device time without the wait for the slowest rank
(``ddp.allreduce_ms.train``, ``gcbench.work.allreduce``)."""

from gcbench.work import allreduce


def read(ctx):
    p = ctx.profile
    nbytes = ctx.work.get("allreduce_bytes")
    if p is None or p.n <= 0 or not nbytes:
        return None
    t = allreduce.transfer_ns(ctx.ranks or [p])
    if not t:
        return None
    return allreduce.bus_bytes(nbytes, ctx.work["world"]) / (
        t * 1e-9 / p.n) * 1e-9
