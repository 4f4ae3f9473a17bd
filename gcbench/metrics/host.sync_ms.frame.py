"""Host ms a frame inside its synchronisations with the device (the calls
``host.syncs.frame`` counts), from the profiled pass.  Also writes the
pass's split of idle time and synchronisations by span to standard error
(``gcbench.spans.report``)."""

from gcbench import spans


def read(ctx):
    if ctx.profile is None:
        return None
    spans.report(ctx.profile)
    return spans.sync_ms(ctx.profile)
