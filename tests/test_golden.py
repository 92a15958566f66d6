"""Golden regression tests: committed 64x64@4spp oracle renders must match
bitwise on the CPU backend (counter-based RNG makes renders deterministic;
any drift is a real semantics change).  Regenerate intentionally with
`python tools/make_goldens.py --regression-only`."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
from tools.make_goldens import (CAMERAS, REG_CFG, REG_SPP, SCENES,  # noqa: E402
                                build)

GOLD_DIR = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.mark.parametrize("name,path", SCENES,
                         ids=[n for n, _ in SCENES])
def test_golden(name, path):
    gold_path = os.path.join(GOLD_DIR, f"{name}.npy")
    if not os.path.exists(gold_path):
        pytest.skip("golden not generated")
    from raymarchrenderer.core.camera import Camera
    from raymarchrenderer.render.config import RenderConfig
    from raymarchrenderer.render.integrator import render
    scene = build(name, path)
    cfg = RenderConfig(**REG_CFG)
    cam = Camera(aspect=1.0)
    if name in CAMERAS:
        cam.eye = CAMERAS[name][0]
        cam.look_at(CAMERAS[name][1])
    img, _ = render(scene, scene.init_params(), cfg,
                    cam.corner_rays_flat(), spp=REG_SPP)
    gold = np.load(gold_path)
    np.testing.assert_array_equal(np.asarray(img), gold)
