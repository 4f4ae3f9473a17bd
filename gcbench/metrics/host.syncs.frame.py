"""Host synchronisations with the device a frame: the
``cudaStreamSynchronize``, ``cudaDeviceSynchronize`` and
``cudaEventSynchronize`` calls inside the program's ``gct/frame#`` and
``gct/frame.readback`` spans in the profiled pass (``gcbench.spans``), a
frame."""

from gcbench import spans


def read(ctx):
    return None if ctx.profile is None else spans.syncs(ctx.profile)
