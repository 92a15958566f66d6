"""Pallas fused-kernel parity vs the pure-JAX oracle (SURVEY.md §4 item 2).

Runs the Triton-route kernels in interpreter mode on CPU (the "fake
backend").  Single
samples are bitwise-identical (same RNG, same op order); multi-sample and
NEE paths accumulate in a different order, so a few rays near the hit_eps
threshold may flip — parity is therefore: tiny max diff on ≥99.9% of
pixels.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from raymarchrenderer.core.camera import Camera
from raymarchrenderer.kernels.march import (
    render_fused, render_progressive_fused,
)
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import render, render_sample
from raymarchrenderer.scene import builtin

CFG = RenderConfig(width=128, height=32, spp=1, max_steps=96,
                   max_bounces=3, max_dist=100.0)
BLOCK = (8, 128)


def _corners(aspect=4.0):
    return Camera(aspect=aspect).corner_rays_flat()


def _frac_off(a, b, tol=1e-3):
    return float((np.abs(np.asarray(a) - np.asarray(b)) > tol).mean())


class TestFusedParity:
    def test_single_sample_bitwise(self):
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        oracle = render_sample(scene, params, CFG, _corners(),
                               jnp.uint32(5)).stack(-1)
        fused = render_fused(scene, params, CFG, _corners(), jnp.uint32(5),
                             n_samples=1, block=BLOCK, interpret=True)
        np.testing.assert_array_equal(np.asarray(oracle), np.asarray(fused))

    def test_multi_sample_mean(self):
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        o = [render_sample(scene, params, CFG, _corners(),
                           jnp.uint32(s)).stack(-1) for s in (3, 4, 5, 6)]
        mean = sum(np.asarray(x) for x in o) / 4.0
        fused = render_fused(scene, params, CFG, _corners(), jnp.uint32(3),
                             n_samples=4, block=BLOCK, interpret=True)
        assert _frac_off(mean, fused) < 1e-3

    def test_nee_direct_light(self):
        scene = builtin.csg_demo()
        params = scene.init_params()
        oracle = render_sample(scene, params, CFG, _corners(), jnp.uint32(1),
                               direct_light=True).stack(-1)
        fused = render_fused(scene, params, CFG, _corners(), jnp.uint32(1),
                             n_samples=1, direct_light=True, block=BLOCK,
                             interpret=True)
        assert _frac_off(oracle, fused) < 1e-3

    def test_data_driven_scene_from_file(self):
        from raymarchrenderer.scene import load_scene
        scene = load_scene("data/scenes/default.scene")
        params = scene.init_params()
        oracle = render_sample(scene, params, CFG, _corners(),
                               jnp.uint32(0)).stack(-1)
        fused = render_fused(scene, params, CFG, _corners(), jnp.uint32(0),
                             n_samples=1, block=BLOCK, interpret=True)
        np.testing.assert_array_equal(np.asarray(oracle), np.asarray(fused))

    def test_progressive_matches_oracle_render(self):
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        img_o, n_o = render(scene, params, CFG, _corners(), spp=4)
        img_f, n_f = render_progressive_fused(
            scene, params, CFG, _corners(), spp=4, samples_per_launch=2,
            interpret=True)
        assert n_o == n_f == 4.0
        assert _frac_off(img_o, img_f) < 1e-3

    def test_env_map_deferred_sky(self):
        """Env-map scenes run the megakernel with the (bilinear) sky
        gather deferred to an XLA composite.

        Tolerance note: the banked miss THROUGHPUT is bitwise-equal to the
        oracle's, but bounce DIRECTIONS diverge at FMA-contraction level
        (~4e-5) between the kernel and oracle compilations — invisible
        under a nearest-neighbor or constant sky (every fused-vs-oracle
        bitwise test elsewhere), but a bilinear lookup is continuous in
        direction, so the radiance inherits an O(1e-3) wobble.  Physically
        meaningless; asserted tight, not bitwise."""
        rng = np.random.RandomState(7)
        img = rng.uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32)
        b = builtin.SceneBuilder()
        m = b.diffuse([0.6, 0.5, 0.4])
        b.sphere(m, [0.0, 1.0, 0.0], 1.0)
        b.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
        scene = b.build(env_image=img)
        params = scene.init_params()
        oracle = render_sample(scene, params, CFG, _corners(),
                               jnp.uint32(2)).stack(-1)
        fused = render_fused(scene, params, CFG, _corners(), jnp.uint32(2),
                             n_samples=1, block=BLOCK, interpret=True)
        np.testing.assert_allclose(np.asarray(oracle), np.asarray(fused),
                                   atol=5e-3)

    def test_env_map_deferred_sky_multisample(self):
        img = np.ones((4, 8, 3), np.float32) * 0.5
        img[:2] = 2.0
        b = builtin.SceneBuilder()
        m = b.diffuse([0.5, 0.5, 0.5])
        b.sphere(m, [0.0, 1.0, 0.0], 1.0)
        scene = b.build(env_image=img)
        params = scene.init_params()
        o = [render_sample(scene, params, CFG, _corners(),
                           jnp.uint32(s)).stack(-1) for s in (1, 2)]
        mean = sum(np.asarray(x) for x in o) / 2.0
        fused = render_fused(scene, params, CFG, _corners(), jnp.uint32(1),
                             n_samples=2, block=BLOCK, interpret=True)
        assert _frac_off(mean, fused) < 1e-3

    def test_env_map_with_nee(self):
        """env-map x direct-light on the fused megakernel: missed paths
        bank their accumulated NEE radiance in-kernel and only the
        thr*sky term defers to the composite (the oracle's defer_sky
        trace returns color=0 + extra for misses)."""
        rng = np.random.RandomState(13)
        img = rng.uniform(0.0, 1.5, (8, 16, 3)).astype(np.float32)
        b = builtin.SceneBuilder()
        m = b.diffuse([0.6, 0.5, 0.4])
        b.sphere(m, [0.0, 1.0, 0.0], 1.0)
        b.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
        b.light([3, 6, -3], 40.0, 0.5)
        scene = b.build(env_image=img)
        params = scene.init_params()
        oracle = render_sample(scene, params, CFG, _corners(), jnp.uint32(2),
                               direct_light=True).stack(-1)
        fused = render_fused(scene, params, CFG, _corners(), jnp.uint32(2),
                             n_samples=1, direct_light=True, block=BLOCK,
                             interpret=True)
        assert _frac_off(oracle, fused, tol=5e-3) < 2e-3

    def test_env_map_nearest_filter(self):
        """env_filter="nearest" (1-tap GL_NEAREST, the gather-wall perf
        knob) flows through both oracle and fused paths consistently."""
        rng = np.random.RandomState(11)
        img = rng.uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32)
        b = builtin.SceneBuilder()
        m = b.diffuse([0.6, 0.5, 0.4])
        b.sphere(m, [0.0, 1.0, 0.0], 1.0)
        scene = b.build(env_image=img, env_filter="nearest")
        params = scene.init_params()
        oracle = render_sample(scene, params, CFG, _corners(),
                               jnp.uint32(3)).stack(-1)
        fused = render_fused(scene, params, CFG, _corners(), jnp.uint32(3),
                             n_samples=1, block=BLOCK, interpret=True)
        # nearest lookups are piecewise-constant in (u, v): the packed
        # 16-bit uv bank quantization can flip a tap across a texel edge
        # on a handful of rays — bound the count, not per-pixel equality
        assert _frac_off(oracle, fused, tol=1e-3) < 5e-3
        # and the filter actually differs from linear
        lin = b.build(env_image=img, env_filter="linear")
        lp = lin.init_params()
        lin_img = render_sample(lin, lp, CFG, _corners(),
                                jnp.uint32(3)).stack(-1)
        assert not np.allclose(np.asarray(oracle), np.asarray(lin_img))

    def test_small_frame_clamps_block(self):
        # frames smaller than the block clamp the block to the frame
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        out = render_fused(scene, params, CFG.replace(width=100), _corners(),
                           jnp.uint32(0), block=BLOCK, interpret=True)
        assert out.shape == (CFG.height, 100, 3)

    def test_misaligned_frame_pads_and_crops(self):
        # frames that don't tile by the block are padded to a block
        # multiple inside the launch and cropped after; kept pixels are
        # bitwise-equal to the oracle (RNG keyed on absolute coords, every
        # pixel independent).  149 is prime — the old shrink-to-divisor
        # fallback would have degraded to 1-wide tiles here.
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        cfg = CFG.replace(width=149, height=13)
        oracle = render_sample(scene, params, cfg, _corners(),
                               jnp.uint32(0)).stack(-1)
        fused = render_fused(scene, params, cfg, _corners(), jnp.uint32(0),
                             n_samples=1, block=BLOCK, interpret=True)
        assert fused.shape == (13, 149, 3)
        np.testing.assert_array_equal(np.asarray(oracle), np.asarray(fused))

    def test_misaligned_frame_spectral_pads(self):
        from raymarchrenderer.kernels.march import render_fused_spectral
        from raymarchrenderer.render.spectral_integrator import (
            render_sample_spectral, spectral_demo)
        scene, params, mats = spectral_demo()
        cfg = CFG.replace(width=149, height=13, max_bounces=3)
        oracle = render_sample_spectral(scene, params, mats, cfg,
                                        _corners(), jnp.uint32(1)).stack(-1)
        fused = render_fused_spectral(scene, params, mats, cfg, _corners(),
                                      jnp.uint32(1), n_samples=1,
                                      block=BLOCK, interpret=True)
        assert fused.shape == (13, 149, 3)
        # same tolerance as test_fused_spectral_matches_oracle (the fused
        # spectral trace differs from the oracle at FMA-contraction level)
        d = np.abs(np.asarray(oracle) - np.asarray(fused))
        assert float((d > 1e-5).mean()) < 1e-3


class TestFusedDispersion:
    """`separate_channels` (gen-1 dispersion, `RayMarch.glsl:580-598`)
    inside the fused kernel: the megakernel folds the channel into the
    path-regeneration loop (3 one-hot paths per sample), sharing the
    sample's primary ray and drawing shade stream s·4+ci+1 — the oracle's
    exact keying."""

    def test_mega_single_sample_bitwise(self):
        scene = builtin.glass_demo()
        params = scene.init_params()
        cfg = CFG.replace(separate_channels=True)
        oracle = render_sample(scene, params, cfg, _corners(),
                               jnp.uint32(2)).stack(-1)
        fused = render_fused(scene, params, cfg, _corners(), jnp.uint32(2),
                             n_samples=1, block=BLOCK, interpret=True)
        # single sample banks R, G, B in the oracle's association order
        np.testing.assert_array_equal(np.asarray(oracle), np.asarray(fused))

    def test_mega_multi_sample(self):
        scene = builtin.glass_demo()
        params = scene.init_params()
        cfg = CFG.replace(separate_channels=True)
        o = [render_sample(scene, params, cfg, _corners(),
                           jnp.uint32(s)).stack(-1) for s in (1, 2, 3)]
        mean = sum(np.asarray(x) for x in o) / 3.0
        fused = render_fused(scene, params, cfg, _corners(), jnp.uint32(1),
                             n_samples=3, block=BLOCK, interpret=True)
        # multi-sample banking re-associates the float32 sum
        assert _frac_off(mean, fused) < 1e-3

    def test_env_map_dispersion_matches_oracle(self):
        """`separate_channels` composes with the deferred-sky env path:
        the bank slots enumerate (sample, channel) paths — 3 per sample,
        each with its own miss event (RayMarch.glsl:580-598 + :78-113
        together).  Tolerance as in test_env_map_deferred_sky (bilinear
        sky lookup inherits FMA-level direction wobble)."""
        rng = np.random.RandomState(3)
        img = rng.uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32)
        b = builtin.SceneBuilder()
        g = b.glass([0.9, 0.95, 1.0], ior=1.45)
        b.sphere(g, [0.0, 1.0, 0.0], 1.0)
        d = b.diffuse([0.5, 0.5, 0.5])
        b.box(d, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
        scene = b.build(env_image=img)
        params = scene.init_params()
        cfg = CFG.replace(separate_channels=True)
        o = [render_sample(scene, params, cfg, _corners(),
                           jnp.uint32(s)).stack(-1) for s in (1, 2)]
        mean = sum(np.asarray(x) for x in o) / 2.0
        fused = render_fused(scene, params, cfg, _corners(), jnp.uint32(1),
                             n_samples=2, block=BLOCK, interpret=True)
        assert _frac_off(mean, fused, tol=5e-3) < 1e-3


class TestFusedSpectral:
    @pytest.mark.parametrize("block", [BLOCK, (16, 16)],
                             ids=["8x128", "16x16"])
    def test_fused_spectral_matches_oracle(self, block):
        import numpy as np

        from raymarchrenderer.kernels.march import render_fused_spectral
        from raymarchrenderer.render.spectral_integrator import (
            render_sample_spectral, spectral_demo)
        scene, params, mats = spectral_demo()
        cfg = CFG.replace(max_bounces=3)
        a = np.asarray(render_sample_spectral(scene, params, mats, cfg,
                                              _corners(), jnp.uint32(1)).stack(-1))
        b = np.asarray(render_fused_spectral(scene, params, mats, cfg,
                                             _corners(), jnp.uint32(1),
                                             n_samples=1, block=block,
                                             interpret=True))
        d = np.abs(a - b)
        assert float((d > 1e-5).mean()) < 1e-3

    def test_fused_spectral_mega_multisample(self):
        import numpy as np

        from raymarchrenderer.kernels.march import render_fused_spectral
        from raymarchrenderer.render.spectral_integrator import (
            render_sample_spectral, spectral_demo)
        scene, params, mats = spectral_demo()
        cfg = CFG.replace(max_bounces=3)
        o = [np.asarray(render_sample_spectral(
            scene, params, mats, cfg, _corners(), jnp.uint32(s)).stack(-1))
            for s in (2, 3, 4)]
        mean = sum(o) / 3.0
        b = np.asarray(render_fused_spectral(scene, params, mats, cfg,
                                             _corners(), jnp.uint32(2),
                                             n_samples=3, block=BLOCK,
                                             interpret=True))
        assert _frac_off(mean, b) < 1e-3
