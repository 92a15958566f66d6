from raymarchrenderer.kernels.march import (  # noqa: F401
    render_fused, render_sample_fused,
)
