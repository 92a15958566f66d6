"""Oracle renderer tests: determinism, golden statistics, tile/full-frame
equivalence, spiral scheduler parity, spectral mode, progressive resume."""
import jax.numpy as jnp
import numpy as np

from raymarchrenderer.core.camera import Camera
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import render, render_sample
from raymarchrenderer.render.spectral_integrator import (
    render_spectral, spectral_demo,
)
from raymarchrenderer.render.tiles import ProgressiveRenderer, spiral_tiles
from raymarchrenderer.scene import builtin

CFG = RenderConfig(width=64, height=64, spp=2, max_steps=96, max_bounces=4,
                   max_dist=100.0)


def _corners():
    return Camera(aspect=1.0).corner_rays_flat()


class TestOracle:
    def test_finite_and_deterministic(self):
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        img1, n = render(scene, params, CFG, _corners(), spp=2)
        img2, _ = render(scene, params, CFG, _corners(), spp=2)
        a = np.asarray(img1)
        assert n == 2.0
        assert np.all(np.isfinite(a))
        assert a.max() > 0.0
        np.testing.assert_array_equal(a, np.asarray(img2))

    def test_golden_statistics(self):
        # The emitter sphere (power 8) lights the scene; the converged mean
        # must sit in a stable band.  This is the statistical golden test
        # replacing the reference's eyeballed output/*.bmp baselines.
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        img, _ = render(scene, params, CFG, _corners(), spp=8)
        m = float(np.asarray(img).mean())
        assert 0.1 < m < 1.5

    def test_emitter_pixels_bright(self):
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        img, _ = render(scene, params, CFG, _corners(), spp=1)
        a = np.asarray(img)
        # direct emitter hits produce color 8.0 — the image max reflects it
        assert a.max() > 4.0

    def test_seed_changes_noise(self):
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        img1, _ = render(scene, params, CFG, _corners(), spp=1)
        img2, _ = render(scene, params, CFG.replace(seed=1), _corners(), spp=1)
        assert not np.array_equal(np.asarray(img1), np.asarray(img2))

    def test_resume_matches_straight_run(self):
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        full, n_full = render(scene, params, CFG, _corners(), spp=4)
        half, n_half = render(scene, params, CFG, _corners(), spp=2)
        resumed, n_res = render(scene, params, CFG, _corners(), spp=2,
                                accum=half, n0=n_half)
        assert n_res == 4.0
        np.testing.assert_allclose(np.asarray(resumed), np.asarray(full),
                                   rtol=1e-5, atol=1e-6)

    def test_direct_light_adds_energy(self):
        scene = builtin.csg_demo()
        params = scene.init_params()
        img_off, _ = render(scene, params, CFG, _corners(), spp=2)
        img_on, _ = render(scene, params, CFG, _corners(), spp=2,
                           direct_light=True)
        assert np.asarray(img_on).mean() > np.asarray(img_off).mean()
        assert np.all(np.isfinite(np.asarray(img_on)))


class TestDispersion:
    """`separate_channels` — the gen-1/gen-2 3-pass RGB dispersion
    (`RayMarch.glsl:586-598`): R, G, B traced as independent masked paths
    and summed."""

    def test_channel_isolation(self):
        """A channel's output comes only from its own masked trace: zeroing
        a material's G+B response must leave the R channel bitwise
        unchanged (each pass draws its own RNG stream keyed by channel)."""
        import jax
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        cfg = CFG.replace(separate_channels=True)
        a = np.asarray(render_sample(scene, params, cfg, _corners(),
                                     jnp.uint32(0)).stack(-1))
        # scale every material-color leaf's G and B
        mod = jax.tree.map(lambda x: x, params)
        mats = [[leaf * jnp.asarray([1.0, 0.3, 0.3])
                 if jnp.shape(leaf) == (3,) else leaf for leaf in m]
                for m in mod["materials"]]
        mod = dict(mod, materials=mats)
        b = np.asarray(render_sample(scene, mod, cfg, _corners(),
                                     jnp.uint32(0)).stack(-1))
        assert np.isfinite(a).all() and a.max() > 0
        np.testing.assert_array_equal(a[..., 0], b[..., 0])
        assert np.abs(a[..., 1] - b[..., 1]).max() > 0

    def test_same_expectation_as_combined(self):
        """For an achromatic light path the dispersion estimator has the
        same expectation as the combined trace — means agree at modest spp
        (the two modes draw different streams, so compare statistically)."""
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        spp = 16
        cfg = CFG.replace(width=32, height=32, max_bounces=3)
        img_c, _ = render(scene, params, cfg, _corners(), spp=spp)
        img_d, _ = render(scene, params, cfg.replace(separate_channels=True),
                          _corners(), spp=spp)
        mc = float(np.asarray(img_c).mean())
        md = float(np.asarray(img_d).mean())
        assert abs(mc - md) / mc < 0.25, (mc, md)


class TestTiles:
    def test_spiral_visits_every_tile_once(self):
        for gw, gh in [(4, 4), (3, 5), (1, 1), (2, 2), (5, 3)]:
            order = list(spiral_tiles(gw, gh))
            assert sorted(order) == [(x, y) for x in range(gw)
                                     for y in range(gh)]

    def test_spiral_starts_at_centre(self):
        order = list(spiral_tiles(4, 4))
        assert order[0] == (1, 1)   # ceil(4/2)-1 = 1 (Program.cpp:113-114)
        # the turn bookkeeping fires on the very first advance
        # (distCount*2 == 0 == squaresPassed-lastSquaresPassed,
        # Program.cpp:206-211), so dir=(-1,0) rotates to (0,1) before the
        # first move: the walk starts downward, then spirals
        assert order[1] == (1, 2)
        assert order[2] == (2, 2)

    def test_tiled_equals_full_frame(self):
        # tile rendering must be bitwise-identical to the full frame — the
        # property that makes tile sharding across chips exact
        scene = builtin.sphere_on_floor()
        params = scene.init_params()
        cfg = CFG.replace(grid_width=2, grid_height=2, spp=1)
        full, _ = render(scene, params, cfg, _corners(), spp=1)
        pr = ProgressiveRenderer(scene, params, cfg, _corners())
        tiled = pr.render_pass(spp=1)
        np.testing.assert_array_equal(np.asarray(full), np.asarray(tiled))

    def test_endless_mode_accumulates(self):
        scene = builtin.single_sphere()
        params = scene.init_params()
        cfg = CFG.replace(grid_width=2, grid_height=2, width=32, height=32,
                          max_bounces=2)
        pr = ProgressiveRenderer(scene, params, cfg, _corners())
        img = pr.endless_passes(2)
        assert pr.pass_n == 2.0
        assert np.all(np.isfinite(np.asarray(img)))


class TestSpectral:
    def test_spectral_demo_renders(self):
        scene, params, mats = spectral_demo()
        cfg = CFG.replace(width=32, height=32, max_bounces=4)
        img, n = render_spectral(scene, params, mats, cfg, _corners(), spp=4)
        a = np.asarray(img)
        assert np.all(np.isfinite(a))
        assert a.max() > 0.0
        # the sphere band-filters to 490-590 nm → green-dominant overall tint
        # relative to blue in sphere pixels is hard to assert at 32²; just
        # check all three channels receive energy from the 380-780 emitter
        assert a[..., 0].max() > 0 and a[..., 1].max() > 0 and a[..., 2].max() > 0

    def test_wavelength_bins(self):
        scene, params, mats = spectral_demo()
        from raymarchrenderer.core.vecmath import Vec3
        from raymarchrenderer.render.spectral_integrator import trace_spectral
        from raymarchrenderer.render.config import RenderConfig
        cfg = RenderConfig(width=8, height=8, max_steps=64, max_bounces=4,
                           max_dist=100.0)
        shape = (8, 8)
        eye = Vec3.full(shape, 0.0, 4.0, -6.0)
        d = Vec3.full(shape, 0.0, -3.0, 6.0).normalized()
        px = jnp.zeros(shape, jnp.uint32)
        py = jnp.zeros(shape, jnp.uint32)
        wl, power = trace_spectral(scene, params, mats, cfg, eye, d, px, py,
                                   jnp.uint32(0))
        w = np.asarray(wl)
        assert np.all((w == 0) | (w % 5 == 0))  # 5 nm bins or unset
