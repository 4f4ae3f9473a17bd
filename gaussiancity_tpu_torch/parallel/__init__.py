# -*- coding: utf-8 -*-
"""Several processes, one rank each: process groups (``mesh``), the
band-sharded rasterizer (``sharded_raster``) and the sharded two-model
frame (``sharded_infer``)."""
