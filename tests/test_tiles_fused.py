"""Megakernel under the interactive tile driver (round-4 directive):
`ProgressiveRenderer(impl="triton")` drives `render_fused_patch` per spiral
tile and must be BITWISE-equal to the full-frame fused render — the RNG is
keyed on absolute pixel coords and every per-lane value is
schedule-invariant, so the tile decomposition cannot touch the numbers.
"""
import jax.numpy as jnp
import numpy as np

from raymarchrenderer.core.camera import Camera
from raymarchrenderer.kernels.march import render_fused
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.tiles import ProgressiveRenderer
from raymarchrenderer.scene.builtin import SceneBuilder, sphere_on_floor

CFG = RenderConfig(width=256, height=64, spp=2, max_steps=96,
                   max_bounces=3, max_dist=100.0,
                   grid_width=2, grid_height=2)


def _corners():
    return Camera(aspect=4.0).corner_rays_flat()


def test_fused_tiles_bitwise_equal_full_frame():
    scene = sphere_on_floor()
    params = scene.init_params()
    pr = ProgressiveRenderer(scene, params, CFG, _corners(), impl="triton",
                             interpret=True)
    tiled = np.asarray(pr.render_pass(spp=2))
    full = np.asarray(render_fused(scene, params, CFG, _corners(),
                                   jnp.uint32(0), n_samples=2,
                                   interpret=True))
    np.testing.assert_array_equal(tiled, full)


def test_fused_tiles_nee():
    """NEE scenes run on the fused path under the tile driver too (the
    round-3 restriction is gone)."""
    b = SceneBuilder()
    m = b.diffuse([0.7, 0.7, 0.7])
    b.sphere(m, [0, 1, 0], 1.0)
    b.box(m, [0, -0.05, 0], [8, 0.05, 8])
    b.light([3, 6, -3], 40.0, 0.5)
    scene = b.build()
    params = scene.init_params()
    pr = ProgressiveRenderer(scene, params, CFG, _corners(), impl="triton",
                             direct_light=True, interpret=True)
    tiled = np.asarray(pr.render_pass(spp=1))
    full = np.asarray(render_fused(scene, params, CFG, _corners(),
                                   jnp.uint32(0), n_samples=1,
                                   direct_light=True, interpret=True))
    np.testing.assert_array_equal(tiled, full)


def test_fused_endless_matches_oracle_endless():
    """Endless mode (one sample per tile per pass) on the fused driver
    equals the oracle endless driver to the known kernel-vs-oracle
    compilation tolerance (same running-mean bookkeeping)."""
    scene = sphere_on_floor()
    params = scene.init_params()
    a = ProgressiveRenderer(scene, params, CFG, _corners(), impl="triton",
                            interpret=True)
    b = ProgressiveRenderer(scene, params, CFG, _corners(), impl="oracle")
    ia = np.asarray(a.endless_passes(2))
    ib = np.asarray(b.endless_passes(2))
    assert (np.abs(ia - ib) > 1e-3).mean() < 2e-3
