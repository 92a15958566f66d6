from raymarchrenderer.io.image import (  # noqa: F401
    save_bmp, save_png, save_npy, save_image, timestamp_name, load_png,
)
from raymarchrenderer.io.checkpoint import (  # noqa: F401
    save_checkpoint, load_checkpoint, RenderState,
)
from raymarchrenderer.io.hdr import (  # noqa: F401
    load_hdr, loads_hdr, save_hdr, load_env_map,
)
