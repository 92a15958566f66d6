"""Statistical-equivalence tests for the two Monte-Carlo rewrites whose
correctness is a distributional claim, not a pointwise one:

  * Russian roulette (`render.integrator`, `RayMarch2.glsl:488-501`
    semantics): path termination with 1/p compensation must leave the
    converged mean unbiased.
  * `shader_volumeScatter` (`scene/nodes.py`, `RayMarch.glsl:429-474`):
    the reference runs floor(t*100) sequential Bernoulli trials and
    scatters at rand()*t on the first success; our closed form draws the
    exact marginal law in two uniforms.  The test pits the node against a
    literal trial-loop reference on the same configuration.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from raymarchrenderer.core.camera import Camera  # noqa: E402
from raymarchrenderer.core.rng import RNGStream  # noqa: E402
from raymarchrenderer.core.vecmath import Vec3  # noqa: E402
from raymarchrenderer.render.config import RenderConfig  # noqa: E402
from raymarchrenderer.render.integrator import render  # noqa: E402
from raymarchrenderer.scene.builtin import SceneBuilder  # noqa: E402
from raymarchrenderer.scene.nodes import (  # noqa: E402
    ShadeCtx, shader_volume_scatter)


class TestRussianRoulette:
    def test_rr_unbiased_vs_plain(self):
        """Converged means agree RR-on vs RR-off (`RayMarch2.glsl:488-501`:
        survivors carry 1/p throughput, casualties nothing — the estimator
        expectation is unchanged; only the variance moves)."""
        from raymarchrenderer.scene.builtin import cornell
        scene = cornell()  # enclosed: paths stay active deep enough for RR
        params = scene.init_params()
        corners = Camera(eye=(0, 2, 5.4), direction=(0, 0, -1),
                         aspect=1.0).corner_rays_flat()
        base = dict(width=32, height=32, max_steps=96, max_bounces=6,
                    max_dist=60.0)
        spp = 192
        plain_cfg = RenderConfig(**base, rr_start_bounce=-1)
        rr_cfg = RenderConfig(**base, rr_start_bounce=2, rr_min_prob=0.05)
        img_p, _ = render(scene, params, plain_cfg, corners, spp=spp)
        img_r, _ = render(scene, params, rr_cfg, corners, spp=spp)
        a = float(jnp.mean(img_p))
        r = float(jnp.mean(img_r))
        # same RNG pixel streams, different estimators: agreement is
        # statistical.  At 32x32x192spp the frame-mean sigma is ~0.5%;
        # a biased RR (e.g. missing the 1/p) would shift the mean by
        # O(kill rate) = tens of percent.
        assert abs(a - r) / a < 0.03, (a, r)
        # and the variance actually moved — proof the roulette ran
        assert not np.array_equal(np.asarray(img_p), np.asarray(img_r))

    def test_rr_kills_paths(self):
        """With an early, brutal roulette in an ENCLOSED scene (paths
        can't escape to the sky, so they stay active past the start
        bounce) most pixels must see at least one killed path."""
        from raymarchrenderer.scene.builtin import cornell
        scene = cornell()
        params = scene.init_params()
        cam = Camera(eye=(0, 2, 5.4), direction=(0, 0, -1), aspect=1.0)
        corners = cam.corner_rays_flat()
        base = dict(width=16, height=16, max_steps=96, max_bounces=5,
                    max_dist=60.0)
        img_p, _ = render(scene, params,
                          RenderConfig(**base, rr_start_bounce=-1),
                          corners, spp=8)
        img_r, _ = render(scene, params,
                          RenderConfig(**base, rr_start_bounce=1,
                                       rr_min_prob=0.01),
                          corners, spp=8)
        frac_diff = (np.abs(np.asarray(img_p) - np.asarray(img_r))
                     .max(-1) > 1e-6).mean()
        assert frac_diff > 0.3


def _volume_ctx(n, t, inside, density):
    shape = (n,)
    ctx = ShadeCtx(
        origin=Vec3.full(shape, 0.0, 0.0, 0.0),
        dir=Vec3.full(shape, 0.0, 0.0, 1.0),
        t=jnp.full(shape, t, jnp.float32),
        hit=Vec3.full(shape, 0.0, 0.0, float(t)),
        inside=jnp.full(shape, inside, jnp.float32),
        normal=Vec3.full(shape, 0.0, -1.0, 0.0),
        channels=Vec3.full(shape, 1.0, 1.0, 1.0),
        rng=RNGStream(0, jnp.arange(n, dtype=jnp.uint32),
                      jnp.zeros((n,), jnp.uint32), 0))
    col = Vec3.full(shape, 0.5, 0.6, 0.7)
    den = Vec3.full(shape, density, density, density)
    return shader_volume_scatter(ctx, col, den)


class TestVolumeScatterLaw:
    """The closed form vs a literal Bernoulli-trial loop
    (`RayMarch.glsl:429-474`)."""

    N = 200_000
    T = 2.37          # floor(t*100) = 237 trials
    DENSITY = 0.2     # den = grayscale(density)/20 = 0.01

    def _node_outputs(self):
        color, out_dir, inside, hit = _volume_ctx(
            self.N, self.T, 1.0, self.DENSITY)
        scat = np.asarray(inside.x) > 0.5  # scatter keeps inside=1
        z = np.asarray(hit.z)
        return scat, z

    def test_scatter_probability_matches_trial_loop(self):
        scat, _ = self._node_outputs()
        p_node = scat.mean()
        # literal reference loop, vectorized over lanes: first-success
        # over floor(t*100) iid trials of probability den
        rng = np.random.RandomState(1234)
        n_trials = int(np.floor(self.T * 100.0))
        den = self.DENSITY / 20.0
        # memory-light sequential emulation of the trial loop
        alive = np.ones(self.N, bool)
        for _ in range(n_trials):
            u = rng.uniform(size=self.N)
            newly = alive & (u < den)
            alive &= ~newly
        p_loop = 1.0 - alive.mean()
        p_exact = 1.0 - (1.0 - den) ** n_trials
        # binomial sigma at N=2e5, p~0.91: ~6.4e-4; allow 5 sigma
        assert abs(p_node - p_exact) < 5 * np.sqrt(
            p_exact * (1 - p_exact) / self.N), (p_node, p_exact)
        assert abs(p_loop - p_exact) < 5 * np.sqrt(
            p_exact * (1 - p_exact) / self.N), (p_loop, p_exact)

    def test_scatter_position_uniform(self):
        """On the first success the reference scatters at rand()*t —
        uniform over (0, t) regardless of which trial fired.  Check mean,
        variance and deciles of the node's hit positions."""
        scat, z = self._node_outputs()
        pos = z[scat]
        assert len(pos) > 1000
        t = self.T
        se_mean = t / np.sqrt(12 * len(pos))
        assert abs(pos.mean() - t / 2) < 5 * se_mean
        assert abs(pos.var() - t * t / 12) / (t * t / 12) < 0.05
        qs = np.quantile(pos, np.linspace(0.1, 0.9, 9))
        np.testing.assert_allclose(qs, np.linspace(0.1, 0.9, 9) * t,
                                   rtol=0.03)

    def test_passthrough_when_outside(self):
        """Outside the volume the shader is a pure pass-through that sets
        inside=1 (the ray ENTERS, `RayMarch.glsl:459-473`)."""
        color, out_dir, inside, hit = _volume_ctx(
            1024, self.T, 0.0, self.DENSITY)
        assert np.all(np.asarray(inside.x) == 1.0)
        np.testing.assert_array_equal(np.asarray(out_dir.z), 1.0)
        np.testing.assert_array_equal(np.asarray(color.x), 1.0)

    def test_no_scatter_exits_volume(self):
        """Inside with zero density: never scatters, keeps direction, and
        inside flips to 0 (the ray exits)."""
        color, out_dir, inside, hit = _volume_ctx(1024, self.T, 1.0, 0.0)
        assert np.all(np.asarray(inside.x) == 0.0)
        np.testing.assert_array_equal(np.asarray(out_dir.z), 1.0)

    def test_volume_scene_renders(self):
        """The volume builtin actually renders end to end (a volume sphere
        in front of an emitter shows in-scattering: brighter halo pixels
        than the same scene without the volume's density)."""
        def make(density):
            b = SceneBuilder()
            m_vol = b.volume([0.9, 0.9, 0.9], density)
            m_emit = b.emission([1.0, 1.0, 1.0], 4.0)
            b.sphere(m_vol, [0, 1, 0], 1.0)
            b.sphere(m_emit, [0, 1, 6], 2.0)
            b.sky(0.05)
            s = b.build()
            return s

        cfg = RenderConfig(width=24, height=24, max_steps=96,
                           max_bounces=6, max_dist=60.0)
        corners = Camera(eye=(0, 1, -4), direction=(0, 0, 1),
                         aspect=1.0).corner_rays_flat()
        dense, _ = render(make(4.0), make(4.0).init_params(), cfg, corners,
                          spp=48)
        thin, _ = render(make(0.0), make(0.0).init_params(), cfg, corners,
                         spp=48)
        d = np.asarray(dense)
        th = np.asarray(thin)
        assert np.isfinite(d).all()
        # a scattering medium redistributes light: the two renders differ
        # materially over the sphere silhouette
        assert np.abs(d - th).max() > 0.05


class TestMarchInstrumentation:
    """march(with_steps/t_max) invariants: the profiling hook must be a
    pure observer, and the shadow-ray cap must only stop, never move, the
    march."""

    def _march_setup(self, relax):
        from raymarchrenderer.render.integrator import march
        scene = SceneBuilder()
        m = scene.diffuse([0.5, 0.5, 0.5])
        scene.sphere(m, [0, 0, 5], 1.0)
        s = scene.build()
        p = s.init_params()
        cfg = RenderConfig(width=8, height=8, max_steps=96, max_dist=50.0,
                           relax_omega=relax)
        shape = (16,)
        o = Vec3.full(shape, 0.0, 0.0, 0.0)
        # half the lanes aim at the sphere, half miss upward
        import jax.numpy as jnp
        zs = jnp.where(jnp.arange(16) % 2 == 0, 1.0, 0.0)
        ys = 1.0 - zs
        d = Vec3(jnp.zeros(shape), ys.astype(jnp.float32),
                 zs.astype(jnp.float32))
        ones = jnp.ones(shape, jnp.float32)
        act = jnp.ones(shape, bool)
        return march, s, p, cfg, o, d, ones, act

    @pytest.mark.parametrize("relax", [0.0, 1.9])
    def test_with_steps_is_pure_observer(self, relax):
        march, s, p, cfg, o, d, ones, act = self._march_setup(relax)
        t0, m0, h0 = march(s, p, cfg, o, d, ones, act)
        t1, m1, h1, steps = march(s, p, cfg, o, d, ones, act,
                                  with_steps=True)
        np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))
        np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))
        np.testing.assert_array_equal(np.asarray(h0), np.asarray(h1))
        st = np.asarray(steps)
        assert (st >= 1).all() and (st <= cfg.max_steps).all()

    @pytest.mark.parametrize("relax", [0.0, 1.9])
    def test_t_max_caps_misses_without_moving_hits(self, relax):
        march, s, p, cfg, o, d, ones, act = self._march_setup(relax)
        t0, m0, h0 = march(s, p, cfg, o, d, ones, act)
        cap = 7.5
        t1, m1, h1 = march(s, p, cfg, o, d, ones, act, t_max=cap)
        hit = np.asarray(h0)
        # hits (sphere at z=5, first contact t=4) are before the cap:
        # identical
        np.testing.assert_array_equal(np.asarray(t0)[hit],
                                      np.asarray(t1)[hit])
        assert np.asarray(h1)[hit].all()
        # misses stop AT the cap and report miss
        assert (~np.asarray(h1)[~hit]).all()
        np.testing.assert_array_equal(np.asarray(t1)[~hit], cap)

    def test_t_max_shortens_shadow_march_work(self):
        """The NEE rationale: capped marches spend fewer map evals on
        unobstructed rays."""
        march, s, p, cfg, o, d, ones, act = self._march_setup(0.0)
        _, _, _, full = march(s, p, cfg, o, d, ones, act, with_steps=True)
        _, _, _, capped = march(s, p, cfg, o, d, ones, act,
                                with_steps=True, t_max=3.0)
        miss = ~np.asarray(march(s, p, cfg, o, d, ones, act)[2])
        assert np.asarray(capped)[miss].mean() < np.asarray(full)[miss].mean()


class TestFusedRussianRoulette:
    def test_fused_rr_unbiased_vs_plain(self):
        """VERDICT r2 #5 'Done' criterion, stated literally: the FUSED
        megakernel's roulette leaves the converged mean unbiased.  (The
        stronger guarantee — bitwise equality to the statistically-tested
        oracle — is tests/test_mega.py::test_mega_rr_bitwise_matches_
        oracle; this asserts the estimator property end-to-end through
        render_fused itself.)"""
        from raymarchrenderer.kernels.march import render_fused
        from raymarchrenderer.scene.builtin import cornell
        scene = cornell()
        params = scene.init_params()
        corners = Camera(eye=(0, 2, 5.4), direction=(0, 0, -1),
                         aspect=1.0).corner_rays_flat()
        base = dict(width=32, height=32, max_steps=96, max_bounces=6,
                    max_dist=60.0)
        spp = 96
        img_p = render_fused(scene, params,
                             RenderConfig(**base, rr_start_bounce=-1),
                             corners, jnp.uint32(0), n_samples=spp,
                             interpret=True)
        img_r = render_fused(scene, params,
                             RenderConfig(**base, rr_start_bounce=2,
                                          rr_min_prob=0.05),
                             corners, jnp.uint32(0), n_samples=spp,
                             interpret=True)
        a = float(jnp.mean(img_p))
        r = float(jnp.mean(img_r))
        # same RNG pixel streams, different estimators: agreement is
        # statistical (frame-mean sigma ~0.7% at 32x32x96spp; a missing
        # 1/p would shift the mean by tens of percent)
        assert abs(a - r) / a < 0.05, (a, r)
        assert not np.array_equal(np.asarray(img_p), np.asarray(img_r))
