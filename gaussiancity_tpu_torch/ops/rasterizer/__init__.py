from gaussiancity_tpu_torch.ops.rasterizer.api import (  # noqa: F401
    GaussianRasterizerWrapper,
    RenderOutput,
    mark_visible,
    rasterize,
    rasterize_points14,
    unpack_points14,
)
