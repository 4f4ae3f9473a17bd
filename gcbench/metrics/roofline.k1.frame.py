"""Kernel K1's share of its roofline in a frame, in %: the least time
for the blend forward of the traced frames' Gaussians (``gcbench.work.k1``
on the reference's preprocess and binning of the same Gaussians) over
K1's device time by kernel name in the profiled pass."""

import sys

from gcbench.work import peaks

# the kernels of ``csrc/blend_fwd.cu`` and its ``tile_prep_kernel``
KERNELS = ("blend_fwd_kernel", "tile_prep_kernel")


def read(ctx):
    work = ctx.work.get("k1")
    if ctx.profile is None or not work:
        return None
    t = ctx.profile.kernel_s(KERNELS)
    if t <= 0:
        return None
    bound, by = peaks.bound_s(sum(w["ops"] for w in work),
                              sum(w["bytes"] for w in work))
    print(f"roofline.k1.frame: bound by {by}, {bound * 1e3:.4f} ms of "
          f"{t * 1e3:.4f} ms over {len(work)} frames", file=sys.stderr)
    return bound / t * 100.0
