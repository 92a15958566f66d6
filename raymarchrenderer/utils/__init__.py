from raymarchrenderer.utils.metrics import (  # noqa: F401
    RenderStats, instrumented_sample, MetricsLogger, spectral_path_profile,
)
from raymarchrenderer.utils.profiling import (  # noqa: F401
    timed_block, trace_to,
)
from raymarchrenderer.utils.guards import checked_render_sample  # noqa: F401
