"""PTv3's kernel launches a frame: the CUDA runtime's launch calls
(``cudaLaunchKernel`` and its family) inside the program's ``gct/ptv3``
spans in the profiled pass, over its frames (``gcbench.spans``).  PTv3
runs torch ops only, each launched through the runtime."""

from gcbench import spans


def read(ctx):
    if ctx.profile is None:
        return None
    return spans.launches_in(ctx.profile, "ptv3")
