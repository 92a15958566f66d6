"""Observability subsystem tests: metrics, profiling, NaN guards."""
import json
import os
import tempfile

import jax.numpy as jnp
import numpy as np

from raymarchrenderer.core.camera import Camera
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.scene import builtin
from raymarchrenderer.utils import (MetricsLogger, checked_render_sample,
                                        instrumented_sample, timed_block)
from raymarchrenderer.utils.profiling import compile_and_steady

CFG = RenderConfig(width=32, height=32, max_steps=64, max_bounces=2,
                   max_dist=100.0)


def _setup():
    scene = builtin.sphere_on_floor()
    return scene, scene.init_params(), Camera(aspect=1.0).corner_rays_flat()


class TestMetrics:
    def test_instrumented_sample(self):
        scene, params, corners = _setup()
        color, stats = instrumented_sample(scene, params, CFG, corners,
                                           jnp.uint32(0))
        assert color.shape == (32, 32, 3)
        assert stats.pixels == 32 * 32
        # the sphere + floor cover part of the frame; sky rays march out
        assert 0.05 < stats.primary_hit_rate < 1.0
        assert 1.0 <= stats.mean_primary_steps <= CFG.max_steps
        assert int(stats.steps_histogram.sum()) == stats.pixels
        assert stats.rays_per_s > 0

    def test_instrumented_matches_plain(self):
        from raymarchrenderer.render.integrator import render_sample
        scene, params, corners = _setup()
        color, _ = instrumented_sample(scene, params, CFG, corners,
                                       jnp.uint32(2))
        plain = render_sample(scene, params, CFG, corners,
                              jnp.uint32(2)).stack(-1)
        np.testing.assert_array_equal(np.asarray(color), np.asarray(plain))

    def test_metrics_logger_jsonl(self):
        scene, params, corners = _setup()
        _, stats = instrumented_sample(scene, params, CFG, corners,
                                       jnp.uint32(0))
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "m.jsonl")
            log = MetricsLogger(p)
            log.log("start", spp=4)
            log.log_stats("sample", stats, sample=0)
            log.close()
            lines = [json.loads(x) for x in open(p)]
        assert lines[0]["event"] == "start"
        assert lines[1]["pixels"] == 32 * 32


class TestProfiling:
    def test_timed_block(self):
        scene, params, corners = _setup()
        out = {}
        with timed_block("render", out):
            from raymarchrenderer.render.integrator import render_sample
            render_sample(scene, params, CFG, corners, jnp.uint32(0))
        assert out["render"] > 0

    def test_compile_and_steady(self):
        import jax

        from raymarchrenderer.render.integrator import render_sample
        scene, params, corners = _setup()
        fn = jax.jit(lambda p: render_sample(scene, p, CFG, corners,
                                             jnp.uint32(0)).stack(-1))
        compile_s, steady_s, out = compile_and_steady(fn, params, reps=2)
        assert out.shape == (32, 32, 3)
        assert compile_s >= steady_s > 0


class TestGuards:
    def test_clean_render_passes(self):
        scene, params, corners = _setup()
        err, img = checked_render_sample(scene, params, CFG, corners,
                                         jnp.uint32(0))
        assert img.shape == (32, 32, 3)

    def test_nan_params_raise(self):
        import jax
        import pytest
        scene, params, corners = _setup()
        bad = jax.tree.map(lambda x: x * jnp.nan, params)
        with pytest.raises(Exception):
            checked_render_sample(scene, bad, CFG, corners, jnp.uint32(0))
