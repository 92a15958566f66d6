from raymarchrenderer.core.vecmath import (  # noqa: F401
    Vec3, vselect, vlerp, reflect, refract, rotate_axis, make_onb,
)
from raymarchrenderer.core import (  # noqa: F401
    camera, color, rng, sampling, sdf, spectral,
)
