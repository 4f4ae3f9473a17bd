"""Frozen plain-PyTorch copy of the port's model, loss, rasterizer,
visibility and extrusion code, the reference that decides ``correct``.

Each module is the port's module of the same path with every hand
kernel replaced by the plain PyTorch version that sat beside it (K1, K2,
K3, G1, G1b, V1, E1 and the ``_kernels`` loader are gone), so that it
runs anywhere torch runs and shares nothing with the program at run
time.  It is a copy and stays one: a later change of the port does not
change what the port is held to.  Float32 only; the callers switch TF32
off (``gcbench.reference.precision``).
"""
