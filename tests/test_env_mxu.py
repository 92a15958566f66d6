"""Mip env lookup (`env_gather="mxu"`): mechanism parity + bounded error.

The deferred-sky composite's equirect lookup is a random gather over the
full-res texture.  `env_gather="mxu"` looks up a solid-angle-prefiltered
table instead (`Scene.sky_uv` on `prefilter_env`'s mip), with the same
filter.  Contracts tested here:

  1. MECHANISM parity: when the env image already has the table's
     resolution the prefilter is the identity, so the mip lookup must
     reproduce the exact GL_LINEAR / GL_NEAREST lookup to float
     tolerance — same footprint, u wrap, v clamp-to-edge.
  2. Prefilter semantics: constant image -> identity; solid-angle (sin θ)
     row weighting, normalized per block.
  3. BOUNDED error end-to-end on smooth (low-frequency) content — the
     miss background the mode is for.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np

from raymarchrenderer.core.camera import Camera
from raymarchrenderer.kernels.march import render_fused
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import render_sample
from raymarchrenderer.scene import builtin
from raymarchrenderer.scene.graph import prefilter_env

CFG = RenderConfig(width=128, height=32, spp=1, max_steps=96,
                   max_bounces=3, max_dist=100.0)
BLOCK = (8, 128)


def _corners(aspect=4.0):
    return Camera(aspect=aspect).corner_rays_flat()


def _env_scene(img, **kw):
    b = builtin.SceneBuilder()
    m = b.diffuse([0.6, 0.5, 0.4])
    b.sphere(m, [0.0, 1.0, 0.0], 1.0)
    b.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
    return b.build(env_image=img, **kw)


class TestMechanismParity:
    """Table res == image res -> identity prefilter -> the mip lookup IS
    the exact lookup."""

    def _uv(self):
        rng = np.random.RandomState(3)
        u = jnp.asarray(rng.uniform(0.0, 1.0, (5, 64)).astype(np.float32))
        v = jnp.asarray(rng.uniform(0.0, 1.0, (5, 64)).astype(np.float32))
        # include the seams: u wrap-around column, v pole rows
        u = u.at[0, :4].set(jnp.asarray([0.0, 0.999999, 0.5, 1.0]))
        v = v.at[0, :4].set(jnp.asarray([0.0, 1.0, 0.003, 0.997]))
        return u, v

    def test_linear(self):
        rng = np.random.RandomState(7)
        img = rng.uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32)
        exact = _env_scene(img, env_gather="exact")
        mxu = dataclasses.replace(_env_scene(img, env_gather="mxu"),
                                  env_mxu_res=(8, 16))
        u, v = self._uv()
        p = exact.init_params()
        a = exact.sky_uv(p, u, v)
        b = mxu.sky_uv(mxu.init_params(), u, v)
        for ca, cb in zip(a, b):
            np.testing.assert_allclose(np.asarray(ca), np.asarray(cb),
                                       atol=2e-6)

    def test_nearest(self):
        rng = np.random.RandomState(9)
        img = rng.uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32)
        exact = _env_scene(img, env_filter="nearest", env_gather="exact")
        mxu = dataclasses.replace(
            _env_scene(img, env_filter="nearest", env_gather="mxu"),
            env_mxu_res=(8, 16))
        u, v = self._uv()
        a = exact.sky_uv(exact.init_params(), u, v)
        b = mxu.sky_uv(mxu.init_params(), u, v)
        for ca, cb in zip(a, b):
            np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))


class TestPrefilter:
    def test_constant_is_identity(self):
        img = jnp.full((64, 128, 3), 1.7, jnp.float32)
        tab = prefilter_env(img, 8, 16)
        assert tab.shape == (8, 16, 3)
        np.testing.assert_allclose(np.asarray(tab), 1.7, rtol=1e-6)

    def test_small_image_passthrough(self):
        img = jnp.arange(4 * 8 * 3, dtype=jnp.float32).reshape(4, 8, 3)
        tab = prefilter_env(img, 32, 64)
        np.testing.assert_array_equal(np.asarray(tab), np.asarray(img))

    def test_solid_angle_weighting(self):
        # two source rows -> one table row: the row nearer the pole has
        # the smaller sin weight, so the blend must tilt toward the
        # equator-side row (a plain box filter would give the midpoint)
        img = np.zeros((4, 4, 3), np.float32)
        img[0] = 1.0   # pole-adjacent row
        img[1] = 3.0
        img[2] = 3.0
        img[3] = 1.0
        tab = np.asarray(prefilter_env(jnp.asarray(img), 2, 4))
        t = (np.arange(4) + 0.5) * np.pi / 4
        w = np.sin(t)
        want_top = (1.0 * w[0] + 3.0 * w[1]) / (w[0] + w[1])
        np.testing.assert_allclose(tab[0], want_top, rtol=1e-6)
        assert tab[0, 0, 0] > 2.0  # tilted toward the equator row's 3.0

    def test_energy_conservation(self):
        # total solid-angle-weighted energy is preserved by blockwise
        # weighted averaging: sum(tab * block_weight) == sum(img * w)
        rng = np.random.RandomState(5)
        img = rng.uniform(0.0, 2.0, (16, 8, 3)).astype(np.float32)
        tab = np.asarray(prefilter_env(jnp.asarray(img), 4, 4))
        t = (np.arange(16) + 0.5) * np.pi / 16
        w = np.sin(t)[:, None, None]
        total = (img * w).sum(axis=(0, 1))
        bw = np.broadcast_to(w, (16, 8, 1)).reshape(4, 4, 4, 2, 1) \
            .sum(axis=(1, 3))
        total_tab = (tab * bw).sum(axis=(0, 1))
        np.testing.assert_allclose(total_tab, total, rtol=1e-5)


class TestEndToEnd:
    def test_fused_mxu_bounded_error_vs_exact(self):
        """Smooth (low-frequency) sky: the fused render under the MXU mip
        lookup stays close to the exact GL_LINEAR render."""
        v = np.linspace(0.0, 1.0, 64)[:, None, None]
        img = (np.array([0.3, 0.5, 1.0]) * (1 - v)
               + np.array([1.0, 0.6, 0.2]) * v)
        img = np.broadcast_to(img, (64, 128, 3)).astype(np.float32)
        exact = _env_scene(img, env_gather="exact")
        mxu = _env_scene(img, env_gather="mxu")
        pe, pm = exact.init_params(), mxu.init_params()
        a = render_fused(exact, pe, CFG, _corners(), jnp.uint32(2),
                         n_samples=1, block=BLOCK, interpret=True)
        b = render_fused(mxu, pm, CFG, _corners(), jnp.uint32(2),
                         n_samples=1, block=BLOCK, interpret=True)
        a, b = np.asarray(a), np.asarray(b)
        # the mip error on a linear-in-v sky is O(block^2 curvature) ~ 0;
        # allow for the sin-weight tilt within each 2x2 block
        assert np.abs(a - b).max() < 0.05
        assert np.abs(a - b).mean() < 0.005

    def test_oracle_mxu_runs(self):
        """env_gather flows through the oracle path too (scene.sky)."""
        rng = np.random.RandomState(2)
        img = rng.uniform(0.0, 1.5, (8, 16, 3)).astype(np.float32)
        mxu = _env_scene(img, env_gather="mxu")
        out = render_sample(mxu, mxu.init_params(), CFG, _corners(),
                            jnp.uint32(1)).stack(-1)
        assert np.isfinite(np.asarray(out)).all()

    def test_prime_spp_tail_chunk(self):
        """spp with no divisor <= 32 (e.g. 37) runs bulk chunks + one tail
        launch — and still equals the mean of per-sample renders (no
        silent depth-1 degradation, no dropped/duplicated samples)."""
        img = np.ones((4, 8, 3), np.float32) * 0.5
        img[:2] = 2.0
        scene = _env_scene(img, env_gather="exact")
        params = scene.init_params()
        spp = 37
        cfg = RenderConfig(width=128, height=8, spp=1, max_steps=48,
                           max_bounces=2, max_dist=100.0)
        o = [np.asarray(render_sample(scene, params, cfg, _corners(16.0),
                                      jnp.uint32(s)).stack(-1))
             for s in range(spp)]
        mean = sum(o) / spp
        fused = render_fused(scene, params, cfg, _corners(16.0),
                             jnp.uint32(0), n_samples=spp, block=BLOCK,
                             interpret=True)
        assert (np.abs(mean - np.asarray(fused)) > 1e-3).mean() < 2e-3
