from raymarchrenderer.scene.graph import (  # noqa: F401
    Scene, MaterialDef, ObjectDef, Light, load_scene, loads_scene,
)
from raymarchrenderer.scene import builtin  # noqa: F401
