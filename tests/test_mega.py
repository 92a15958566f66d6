"""Megakernel integrator parity: `render.mega.trace_mega` must be bitwise
identical to the wavefront oracle `render.integrator.trace_rgb` — same math,
same RNG streams, same multiply order (SURVEY.md §4 item 2: kernel vs oracle
on the CPU fake backend)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarchrenderer.core.camera import Camera
from raymarchrenderer.core.rng import RNGStream
from raymarchrenderer.core.vecmath import Vec3
from raymarchrenderer.render import mega
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import render_sample
from raymarchrenderer.render.raygen import eye_vec, pixel_grid, primary_rays
from raymarchrenderer.scene.builtin import cornell, sphere_on_floor


def _mega_sample(scene, params, cfg, corners, sample, shade_gate=1.0,
                 march_unroll=1, n_samples=1):
    px, py = pixel_grid(cfg.width, cfg.height)
    ch = Vec3.full((cfg.height, cfg.width), 1.0, 1.0, 1.0)
    return mega.trace_mega_paths(scene, params, cfg, corners, px, py,
                                 sample, ch, n_samples=n_samples,
                                 shade_gate=shade_gate,
                                 march_unroll=march_unroll).stack(-1)


CFG = RenderConfig(width=48, height=48, max_steps=192, max_bounces=6,
                   max_dist=100.0)


@pytest.mark.parametrize("sample", [0, 3])
def test_mega_bitwise_matches_oracle(sample):
    scene = sphere_on_floor()
    params = scene.init_params()
    corners = Camera(aspect=1.0).corner_rays_flat()
    a = np.asarray(
        render_sample(scene, params, CFG, corners,
                      jnp.uint32(sample)).stack(-1))
    b = np.asarray(jax.jit(
        lambda p, s: _mega_sample(scene, p, CFG, corners, s)
    )(params, jnp.uint32(sample)))
    np.testing.assert_array_equal(a, b)


def test_mega_spectral_bitwise_matches_oracle():
    """Spectral megakernel (per-lane bounces + in-loop regen) == the gen-3
    wavefront oracle, bitwise — same RNG slots per (pixel, sample, bounce)."""
    from raymarchrenderer.render.raygen import pixel_grid
    from raymarchrenderer.render.spectral_integrator import (
        render_sample_spectral, spectral_demo)
    scene, params, mats = spectral_demo()
    cfg = CFG.replace(max_bounces=4)
    corners = Camera(aspect=1.0).corner_rays_flat()
    px, py = pixel_grid(cfg.width, cfg.height)
    o = [np.asarray(render_sample_spectral(
        scene, params, mats, cfg, corners, jnp.uint32(s)).stack(-1))
        for s in (1, 2)]
    fused = np.asarray(jax.jit(lambda p: mega.trace_mega_spectral(
        scene, p, mats, cfg, corners, px, py, jnp.uint32(1), n_samples=2,
        march_unroll=4).stack(-1))(params))
    np.testing.assert_allclose(o[0] + o[1], fused, rtol=0, atol=1e-6)


def test_mega_gate_invariant():
    """The shade gate is a pure scheduling knob — results are identical for
    any gate value."""
    scene = cornell()
    params = scene.init_params()
    corners = Camera(aspect=1.0).corner_rays_flat()
    outs = [np.asarray(jax.jit(
        lambda p, s, g=g: _mega_sample(scene, p, CFG, corners, s,
                                       shade_gate=g)
    )(params, jnp.uint32(1))) for g in (0.0, 0.25, 1.0, 32.0, 1e9)]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)


def test_mega_unroll_invariant():
    """march_unroll is a pure scheduling knob — bitwise invariant."""
    scene = sphere_on_floor()
    params = scene.init_params()
    corners = Camera(aspect=1.0).corner_rays_flat()
    outs = [np.asarray(jax.jit(
        lambda p, s, u=u: _mega_sample(scene, p, CFG, corners, s,
                                       shade_gate=32.0, march_unroll=u)
    )(params, jnp.uint32(2))) for u in (1, 4, 32)]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)


def test_mega_multisample_matches_sum_of_oracle():
    """Path regeneration: the n_samples trace equals the oracle's
    per-sample sum in the same accumulation order (bitwise)."""
    scene = sphere_on_floor()
    params = scene.init_params()
    corners = Camera(aspect=1.0).corner_rays_flat()
    n = 3
    multi = np.asarray(jax.jit(
        lambda p, s: _mega_sample(scene, p, CFG, corners, s, shade_gate=32.0,
                                  march_unroll=4, n_samples=n)
    )(params, jnp.uint32(5)))
    acc = np.zeros_like(multi)
    for k in range(n):
        acc = acc + np.asarray(
            render_sample(scene, params, CFG, corners,
                          jnp.uint32(5 + k)).stack(-1))
    np.testing.assert_array_equal(multi, acc)


@pytest.mark.parametrize("n_samples", [1, 2])
def test_mega_rr_bitwise_matches_oracle(n_samples):
    """Russian roulette in the megakernel (`RayMarch2.glsl:480-501`): the
    kill/compensate draw is keyed exactly like the oracle's
    (rng.fork(13) at the lane's bounce index), so the result is bitwise
    the oracle's per-sample sum — no silent estimator drift when the
    kernel renders an RR-enabled config."""
    scene = cornell()  # enclosed: paths stay alive deep enough for RR
    params = scene.init_params()
    corners = Camera(eye=(0, 2, 5.4), direction=(0, 0, -1),
                     aspect=1.0).corner_rays_flat()
    cfg = CFG.replace(rr_start_bounce=1, rr_min_prob=0.05)
    acc = None
    for k in range(n_samples):
        o = np.asarray(render_sample(scene, params, cfg, corners,
                                     jnp.uint32(2 + k)).stack(-1))
        acc = o if acc is None else acc + o
    m = np.asarray(jax.jit(
        lambda p, s: _mega_sample(scene, p, cfg, corners, s,
                                  n_samples=n_samples)
    )(params, jnp.uint32(2)))
    np.testing.assert_array_equal(acc, m)
    # and the roulette actually fired: RR-off differs
    off = np.asarray(jax.jit(
        lambda p, s: _mega_sample(scene, p, cfg.replace(rr_start_bounce=-1),
                                  corners, s, n_samples=n_samples)
    )(params, jnp.uint32(2)))
    assert not np.array_equal(m, off)


class TestMegaNEE:
    """NEE in the megakernel: shadow marches run as extra segments of the
    same in-kernel loop (`_SHADOW`/`_SH_LIT`/`_SH_OCC` states), keyed
    exactly like the wavefront oracle's `_direct_light`
    (`RayMarch2.glsl:480-501`).  Tolerance, not bitwise: the NEE falloff
    math (length/1/dist^2) FMA-contracts differently across compilations —
    the ORACLE itself differs eager-vs-jit at ~2e-4 here."""

    @staticmethod
    def _close(a, b):
        d = np.abs(np.asarray(a) - np.asarray(b))
        assert float((d > 1e-3).mean()) < 1e-3, (d.max(), (d > 1e-3).mean())
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-3)

    def _two_light_scene(self):
        from raymarchrenderer.scene.builtin import SceneBuilder
        b = SceneBuilder()
        m = b.diffuse([0.6, 0.5, 0.4])
        g = b.glossy([0.8, 0.8, 0.8], 0.2)
        b.sphere(m, [0.0, 1.0, 0.0], 1.0)
        b.sphere(g, [2.2, 0.7, 0.5], 0.7)
        b.box(m, [0.0, -0.05, 0.0], [8.0, 0.05, 8.0])
        b.light([3, 7, -3], 60.0, 0.8)
        b.light([-4, 5, 2], 40.0, 0.5)
        b.sky(0.05)
        return b.build()

    @pytest.mark.parametrize("n_samples", [1, 2])
    def test_single_light_matches_oracle(self, n_samples):
        from raymarchrenderer.scene.builtin import csg_demo
        scene = csg_demo()
        params = scene.init_params()
        corners = Camera(aspect=1.0).corner_rays_flat()
        px, py = pixel_grid(CFG.width, CFG.height)
        ch = Vec3.full((CFG.height, CFG.width), 1.0, 1.0, 1.0)
        acc = None
        for k in range(n_samples):
            o = np.asarray(render_sample(scene, params, CFG, corners,
                                         jnp.uint32(4 + k),
                                         direct_light=True).stack(-1))
            acc = o if acc is None else acc + o
        m = np.asarray(jax.jit(lambda p: mega.trace_mega_paths(
            scene, p, CFG, corners, px, py, jnp.uint32(4), ch,
            n_samples=n_samples, march_unroll=4,
            direct_light=True).stack(-1))(params))
        self._close(acc, m)
        # NEE actually contributed: direct_light off differs
        off = np.asarray(jax.jit(lambda p: mega.trace_mega_paths(
            scene, p, CFG, corners, px, py, jnp.uint32(4), ch,
            n_samples=n_samples, march_unroll=4).stack(-1))(params))
        assert not np.array_equal(m, off)

    def test_two_lights_matches_oracle(self):
        scene = self._two_light_scene()
        assert scene.n_lights == 2
        params = scene.init_params()
        corners = Camera(aspect=1.0).corner_rays_flat()
        px, py = pixel_grid(CFG.width, CFG.height)
        ch = Vec3.full((CFG.height, CFG.width), 1.0, 1.0, 1.0)
        o = np.asarray(render_sample(scene, params, CFG, corners,
                                     jnp.uint32(7),
                                     direct_light=True).stack(-1))
        m = np.asarray(jax.jit(lambda p: mega.trace_mega(
            scene, p, CFG, corners, px, py, jnp.uint32(7), ch,
            direct_light=True).stack(-1))(params))
        self._close(o, m)

    def test_nee_with_rr_matches_oracle(self):
        """RR kill preserves already-banked NEE radiance (the oracle's
        `extra` survives the kill) — combined estimator stays bitwise."""
        from raymarchrenderer.scene.builtin import csg_demo
        scene = csg_demo()
        params = scene.init_params()
        cfg = CFG.replace(rr_start_bounce=1, rr_min_prob=0.05)
        corners = Camera(aspect=1.0).corner_rays_flat()
        px, py = pixel_grid(cfg.width, cfg.height)
        ch = Vec3.full((cfg.height, cfg.width), 1.0, 1.0, 1.0)
        o = np.asarray(render_sample(scene, params, cfg, corners,
                                     jnp.uint32(1),
                                     direct_light=True).stack(-1))
        m = np.asarray(jax.jit(lambda p: mega.trace_mega(
            scene, p, cfg, corners, px, py, jnp.uint32(1), ch,
            direct_light=True).stack(-1))(params))
        self._close(o, m)

    def test_nee_gate_and_unroll_invariant(self):
        from raymarchrenderer.scene.builtin import csg_demo
        scene = csg_demo()
        params = scene.init_params()
        corners = Camera(aspect=1.0).corner_rays_flat()
        px, py = pixel_grid(CFG.width, CFG.height)
        ch = Vec3.full((CFG.height, CFG.width), 1.0, 1.0, 1.0)
        outs = [np.asarray(jax.jit(lambda p, g=g, u=u: mega.trace_mega_paths(
            scene, p, CFG, corners, px, py, jnp.uint32(0), ch, n_samples=2,
            shade_gate=g, march_unroll=u,
            direct_light=True).stack(-1))(params))
            for g, u in ((0.0, 1), (1.0, 4), (32.0, 8))]
        for o in outs[1:]:
            np.testing.assert_array_equal(outs[0], o)


def test_mega_dispersion_with_nee_matches_oracle():
    """separateChannels × direct-light compose in the megakernel: the
    lane's path counter enumerates (sample, channel) and each hit detours
    through the in-loop shadow chain — same keying as the oracle tracing
    three one-hot channels with NEE (tolerance per TestMegaNEE)."""
    from raymarchrenderer.render.integrator import render_sample
    from raymarchrenderer.scene.builtin import csg_demo
    scene = csg_demo()
    params = scene.init_params()
    cfg = CFG.replace(separate_channels=True, max_bounces=4)
    corners = Camera(aspect=1.0).corner_rays_flat()
    px, py = pixel_grid(cfg.width, cfg.height)
    ch = Vec3.full((cfg.height, cfg.width), 1.0, 1.0, 1.0)
    o = np.asarray(render_sample(scene, params, cfg, corners, jnp.uint32(3),
                                 direct_light=True).stack(-1))
    m = np.asarray(jax.jit(lambda p: mega.trace_mega_paths(
        scene, p, cfg, corners, px, py, jnp.uint32(3), ch, n_samples=1,
        dispersion=True, direct_light=True).stack(-1))(params))
    d = np.abs(o - m)
    # a handful of grazing shadow lanes may flip lit/occluded between the
    # two compilations (see TestMegaNEE docstring) — bound the count and
    # the worst single-lane deviation, not per-pixel equality
    assert float((d > 1e-3).mean()) < 1e-3, (d.max(), (d > 1e-3).mean())
    assert float(d.max()) < 0.1, float(d.max())


class TestRound4ScheduleKnobs:
    """lazy_miss / regen_cadence (round-4 issue-roofline knobs): cadence is
    bitwise by construction (pure scheduling); lazy_miss is converged-equal
    in general and bitwise on scenes whose geometry sits well inside
    max_dist (the headline scene measured bitwise at 1024^2x128 on-chip —
    tools/headline_sweep.py)."""

    def _rgb(self, scene, cfg, corners, **kw):
        px, py = pixel_grid(cfg.width, cfg.height)
        ch = Vec3.full((cfg.height, cfg.width), 1.0, 1.0, 1.0)
        params = scene.init_params()
        return np.asarray(mega.trace_mega_paths(
            scene, params, cfg, corners, px, py, jnp.uint32(1), ch,
            n_samples=2, march_unroll=8, **kw).stack(-1))

    def test_rgb_cadence_bitwise(self):
        scene = sphere_on_floor()
        corners = Camera(aspect=1.0).corner_rays_flat()
        base = self._rgb(scene, CFG, corners)
        np.testing.assert_array_equal(
            base, self._rgb(scene, CFG, corners, regen_cadence=4))

    def test_rgb_lazy_miss_converged_equal(self):
        scene = sphere_on_floor()
        corners = Camera(aspect=1.0).corner_rays_flat()
        base = self._rgb(scene, CFG, corners)
        out = self._rgb(scene, CFG, corners, lazy_miss=True,
                        regen_cadence=4)
        # geometry well inside max_dist and a generous step budget: the
        # boundary miss test fires on the same lane set
        assert (np.abs(out - base) > 1e-4).mean() < 1e-3

    def test_nee_cadence_bitwise(self):
        from raymarchrenderer.scene.builtin import SceneBuilder
        b = SceneBuilder()
        m = b.diffuse([0.7, 0.7, 0.7])
        b.sphere(m, [0, 1, 0], 1.0)
        b.box(m, [0, -0.05, 0], [8, 0.05, 8])
        b.light([3, 6, -3], 40.0, 0.5)
        scene = b.build()
        corners = Camera(aspect=1.0).corner_rays_flat()
        base = self._rgb(scene, CFG, corners, direct_light=True)
        np.testing.assert_array_equal(
            base,
            self._rgb(scene, CFG, corners, direct_light=True,
                      regen_cadence=4))
        lazy = self._rgb(scene, CFG, corners, direct_light=True,
                         lazy_miss=True, regen_cadence=4)
        assert (np.abs(lazy - base) > 1e-4).mean() < 1e-3

    def test_nee_lazy_enclosed_no_bias(self):
        """Round-4 advisor HIGH regression: with lazy_miss, a shadow
        segment could march past its light for up to regen_cadence-1 steps
        and hit geometry BEHIND it (the ceiling here), flipping to _SH_OCC
        — a deterministic darkening of direct light, not noise.  The open
        scene in test_nee_cadence_bitwise cannot catch this; an enclosed
        room with the ceiling just past the light does."""
        from raymarchrenderer.scene.builtin import SceneBuilder
        b = SceneBuilder()
        m = b.diffuse([0.7, 0.7, 0.7])
        b.box(m, [0, -0.05, 0], [8, 0.05, 8])     # floor
        b.box(m, [0, 5.05, 0], [8, 0.05, 8])      # ceiling behind the light
        b.light([0, 2.0, 0], 40.0, 0.1)
        scene = b.build()
        corners = Camera(aspect=1.0).corner_rays_flat()
        cfg = CFG.replace(max_bounces=2)
        px, py = pixel_grid(cfg.width, cfg.height)
        ch = Vec3.full((cfg.height, cfg.width), 1.0, 1.0, 1.0)
        params = scene.init_params()

        def run(**kw):
            return np.asarray(mega.trace_mega_paths(
                scene, params, cfg, corners, px, py, jnp.uint32(1), ch,
                n_samples=2, direct_light=True, march_unroll=16,
                **kw).stack(-1))

        base = run()
        # pre-fix this measured 7% of pixels darker (mean 1.40 -> 1.22,
        # max abs diff 4.9) at the production cadence of 16
        lazy = run(lazy_miss=True, regen_cadence=16)
        d = np.abs(lazy - base)
        assert (d > 1e-4).mean() < 1e-3, (
            float(d.max()), float((d > 1e-4).mean()))
        assert float(lazy.mean()) >= float(base.mean()) - 1e-4

    def test_spectral_cadence_bitwise(self):
        from raymarchrenderer.render.raygen import pixel_grid as pg
        from raymarchrenderer.render.spectral_integrator import (
            spectral_demo)
        scene, params, mats = spectral_demo()
        cfg = CFG.replace(max_bounces=4)
        corners = Camera(aspect=1.0).corner_rays_flat()
        px, py = pg(cfg.width, cfg.height)

        def run(**kw):
            c = mega.trace_mega_spectral(scene, params, mats, cfg, corners,
                                         px, py, jnp.uint32(0),
                                         n_samples=3, march_unroll=8, **kw)
            return np.asarray(c.stack(-1))

        base = run()
        np.testing.assert_array_equal(base, run(regen_cadence=4))
        lazy = run(lazy_miss=True, regen_cadence=4)
        assert (np.abs(lazy - base) > 1e-4).mean() < 1e-3

    def test_record_banks_rejects_occupancy(self):
        """lazy_miss now COMPOSES with recording (round 5b — see
        test_record_banks_bitwise_under_lazy_miss); the occupancy
        counters remain render-only."""
        from raymarchrenderer.render.spectral_integrator import (
            band_table)
        scene = sphere_on_floor()
        params = scene.init_params()
        corners = Camera(aspect=1.0).corner_rays_flat()
        px, py = pixel_grid(8, 8)
        with pytest.raises(ValueError, match="render-only"):
            mega.trace_mega_spectral(scene, params, band_table(scene),
                                     CFG, corners, px, py, jnp.uint32(0),
                                     record_banks=True,
                                     with_occupancy=True)


def test_record_banks_bitwise_under_cadence():
    """Round-5: regen_cadence is enabled for RECORDING (the recording
    kernel is 73% of the train step) — it is pure scheduling, so the
    banked (t, mid, hit[, sd]) planes must be ARRAY-equal to the
    strict-schedule recording."""
    from raymarchrenderer.scene.builtin import csg_demo
    scene = csg_demo()
    params = scene.init_params()
    cfg = CFG.replace(max_bounces=4)
    corners = Camera(aspect=1.0).corner_rays_flat()
    px, py = pixel_grid(cfg.width, cfg.height)
    ch = Vec3.full((cfg.height, cfg.width), 1.0, 1.0, 1.0)

    def rec(cad):
        _, banks = mega.trace_mega_paths(
            scene, params, cfg, corners, px, py, jnp.uint32(0), ch,
            n_samples=2, shade_gate=0.0, march_unroll=32,
            regen_cadence=cad, direct_light=True, record_banks=True)
        return banks

    a = rec(0)
    b = rec(16)
    assert len(a) == len(b) == 4  # t, mid, hit, sd (NEE)
    # scheduling-identical: the same per-lane values computed at a
    # different unrolled-step position.  XLA fuses different unroll
    # positions slightly differently, so a grazing lane's t chain can
    # contract to a 1-ulp different value (measured: 1 element of 18432
    # at 3e-8) — the standard cross-compilation class, NOT an estimator
    # change; ids/hit/visibility must stay exactly equal.
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]),
                               rtol=1e-6, atol=1e-6)
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_record_banks_bitwise_under_lazy_miss():
    """Round-5: lazy_miss composes with RECORDING (the recorded train
    forward now runs the render's own schedule by default): on scenes
    whose geometry sits well inside max_dist the banked planes must be
    ARRAY-equal to the strict-schedule recording — RGB (with NEE: the
    shadow sd bank stays strict-equal here because the scene is open) and
    spectral."""
    from raymarchrenderer.render.spectral_integrator import (
        band_table)
    from raymarchrenderer.scene.builtin import csg_demo
    scene = csg_demo()
    params = scene.init_params()
    # small unroll keeps the four CPU compiles fast while still crossing
    # lazy mark_misses at BOTH the mid-chunk cadence and chunk boundaries.
    # max_steps stays generous (the production budget): a starved step
    # budget makes mid-chunk budget exhaustion COMMON, and lanes that
    # strictly expire mid-chunk but hit geometry within the overshoot
    # window are precisely the documented lazy-vs-strict divergence class
    cfg = CFG.replace(width=32, height=32, max_steps=512, max_bounces=3)
    corners = Camera(aspect=1.0).corner_rays_flat()
    px, py = pixel_grid(cfg.width, cfg.height)
    ch = Vec3.full((cfg.height, cfg.width), 1.0, 1.0, 1.0)

    def rec(lazy):
        _, banks = mega.trace_mega_paths(
            scene, params, cfg, corners, px, py, jnp.uint32(0), ch,
            n_samples=2, shade_gate=0.0, march_unroll=8,
            regen_cadence=4, direct_light=True, record_banks=True,
            lazy_miss=lazy)
        return banks

    a, b = rec(False), rec(True)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    mats = band_table(scene)

    def rec_sp(lazy):
        _, banks = mega.trace_mega_spectral(
            scene, params, mats, cfg, corners, px, py, jnp.uint32(0),
            n_samples=2, shade_gate=0.0, march_unroll=8,
            regen_cadence=4, record_banks=True, lazy_miss=lazy)
        return banks

    a, b = rec_sp(False), rec_sp(True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
