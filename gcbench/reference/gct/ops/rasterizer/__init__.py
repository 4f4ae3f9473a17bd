from gcbench.reference.gct.ops.rasterizer.api import (  # noqa: F401
    RenderOutput,
    rasterize,
    rasterize_points14,
)
