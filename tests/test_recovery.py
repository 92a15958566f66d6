"""Elastic failure recovery (SURVEY.md §5): spp-shard retry/drop semantics.

The estimator algebra under test: sample sums are associative, shards are
counter-keyed, so (a) a retried shard is bitwise-identical, (b) a dropped
shard yields the exact mean over the samples that DID arrive.
"""
import numpy as np
import pytest

from raymarchrenderer.core.camera import Camera
from raymarchrenderer.parallel.recovery import (ElasticResult,
                                                    oracle_shard_fn,
                                                    render_elastic)
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import render
from raymarchrenderer.scene.builtin import sphere_on_floor


@pytest.fixture(scope="module")
def setup():
    scene = sphere_on_floor()
    params = scene.init_params()
    cfg = RenderConfig(width=24, height=24, max_steps=48, max_bounces=2,
                       max_dist=100.0)
    corners = Camera(aspect=1.0).corner_rays_flat()
    return scene, params, cfg, corners


def test_no_failure_matches_straight_render(setup):
    scene, params, cfg, corners = setup
    run = oracle_shard_fn(scene, params, cfg, corners)
    res = render_elastic(run, cfg.height, cfg.width, spp=8, shard_spp=4)
    straight, n = render(scene, params, cfg, corners, spp=8)
    assert res.spp_achieved == 8 and not res.degraded
    # same samples, same counter keys; running mean vs sum/8 differ only
    # in float association
    np.testing.assert_allclose(res.image, np.asarray(straight), atol=1e-6)


def test_transient_failure_retried_bitwise(setup):
    scene, params, cfg, corners = setup
    inner = oracle_shard_fn(scene, params, cfg, corners)
    calls = {"n": 0}

    def flaky(sample0, n):
        calls["n"] += 1
        if sample0 == 4 and calls["n"] == 2:  # first attempt of shard 2
            raise RuntimeError("simulated chip loss")
        return inner(sample0, n)

    res = render_elastic(flaky, cfg.height, cfg.width, spp=8, shard_spp=4,
                         max_retries=1)
    clean = render_elastic(inner, cfg.height, cfg.width, spp=8, shard_spp=4)
    assert res.spp_achieved == 8
    assert len(res.failures) == 1 and res.failures[0].sample0 == 4
    # the retried shard re-runs the SAME counter-keyed samples → bitwise
    np.testing.assert_array_equal(res.image, clean.image)


def test_permanent_failure_drops_shard_unbiased(setup):
    scene, params, cfg, corners = setup
    inner = oracle_shard_fn(scene, params, cfg, corners)

    def dead_shard(sample0, n):
        if sample0 == 4:
            raise RuntimeError("host gone")
        return inner(sample0, n)

    res = render_elastic(dead_shard, cfg.height, cfg.width, spp=12,
                         shard_spp=4, max_retries=2)
    assert res.degraded
    assert res.spp_achieved == 8
    assert res.dropped_shards == [4]
    assert len(res.failures) == 3  # 1 + 2 retries
    # exact mean over the samples that arrived (shards 0-3 and 8-11)
    manual = (np.asarray(inner(0, 4)) + np.asarray(inner(8, 4))) / 8.0
    np.testing.assert_array_equal(res.image, manual.astype(np.float32))


def test_fused_shard_fn_matches_oracle_shards(setup):
    scene, params, cfg, corners = setup
    from raymarchrenderer.parallel.recovery import fused_shard_fn
    run_o = oracle_shard_fn(scene, params, cfg, corners)
    run_f = fused_shard_fn(scene, params, cfg, corners, interpret=True)
    a = render_elastic(run_o, cfg.height, cfg.width, spp=4, shard_spp=2)
    b = render_elastic(run_f, cfg.height, cfg.width, spp=4, shard_spp=2)
    np.testing.assert_array_equal(a.image, b.image)


def test_result_shape_and_fields():
    res = render_elastic(lambda s0, n: np.zeros((4, 4, 3), np.float32),
                         4, 4, spp=4, shard_spp=4)
    assert isinstance(res, ElasticResult)
    assert res.image.shape == (4, 4, 3)
    assert res.spp_requested == res.spp_achieved == 4
