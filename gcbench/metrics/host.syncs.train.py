"""Host synchronisations with the device a train step: the
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` and
``cudaEventSynchronize`` calls inside the program's ``gct/train_step#``
spans in the profiled pass (``gcbench.spans``), a step."""

from gcbench import spans


def read(ctx):
    return None if ctx.profile is None else spans.syncs(ctx.profile)
