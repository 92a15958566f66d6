from raymarchrenderer.render.config import RenderConfig, TINY  # noqa: F401
from raymarchrenderer.render.integrator import (  # noqa: F401
    march, get_normal, trace_rgb, render_sample, render,
)
