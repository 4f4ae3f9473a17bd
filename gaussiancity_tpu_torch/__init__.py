"""gaussiancity_tpu_torch: the PyTorch / CUDA port of gaussiancity_tpu.

The JAX package beside it is the reference; this package imports nothing
of it.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; hand-written Hopper kernels live in ``csrc/`` and are
built at first use by ``_kernels.py``.
"""

__version__ = "0.1.0"
