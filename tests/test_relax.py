"""Over-relaxed sphere tracing (`cfg.relax_omega` > 1, Keinert et al. 2014).

The safeguard guarantees the relaxed march finds exactly the hits the
classic march (`RayMarch.glsl:233-257` semantics) finds, for any
distance-underestimating SDF — same hit mask, same material, hit `t` within
the surface-ε band — in far fewer map evals.  The megakernel and the
wavefront oracle must agree bitwise in relaxed mode too (it is the same
per-lane algorithm restated)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarchrenderer.core.camera import Camera
from raymarchrenderer.core.rng import RNGStream
from raymarchrenderer.core.vecmath import Vec3
from raymarchrenderer.render import mega
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import march, render_sample
from raymarchrenderer.render.raygen import eye_vec, pixel_grid, primary_rays
from raymarchrenderer.scene.builtin import cornell, csg_demo, sphere_on_floor

CFG = RenderConfig(width=48, height=48, max_steps=256, max_bounces=6,
                   max_dist=100.0)
RELAXED = CFG.replace(relax_omega=1.6)


def _primary(scene, cfg):
    params = scene.init_params()
    corners = Camera(aspect=1.0).corner_rays_flat()
    px, py = pixel_grid(cfg.width, cfg.height)
    rng = RNGStream(cfg.seed, px, py, jnp.uint32(0), jnp.uint32(1 << 20))
    d = primary_rays(corners, px, py, cfg.width, cfg.height, rng)
    e = eye_vec(corners)
    shape = (cfg.height, cfg.width)
    o = Vec3(jnp.broadcast_to(e.x, shape), jnp.broadcast_to(e.y, shape),
             jnp.broadcast_to(e.z, shape))
    ones = jnp.ones(shape, jnp.float32)
    return params, o, d, ones


@pytest.mark.parametrize("make_scene", [sphere_on_floor, cornell, csg_demo])
def test_relaxed_march_same_hits(make_scene):
    scene = make_scene()
    params, o, d, ones = _primary(scene, CFG)
    t0, m0, h0 = jax.jit(
        lambda p: march(scene, p, CFG, o, d, ones, ones > 0))(params)
    t1, m1, h1 = jax.jit(
        lambda p: march(scene, p, RELAXED, o, d, ones, ones > 0))(params)
    np.testing.assert_array_equal(np.asarray(h0), np.asarray(h1))
    np.testing.assert_array_equal(np.asarray(m0), np.asarray(m1))
    # both marches stop inside the ε band in front of the surface; their t
    # may differ by a few ε along grazing rays
    hits = np.asarray(h0)
    dt = np.abs(np.asarray(t0) - np.asarray(t1))[hits]
    assert dt.max() <= 0.02, dt.max()


def test_relaxed_mega_matches_relaxed_oracle():
    """Megakernel relax mode is the same algorithm — bitwise equal."""
    scene = cornell()
    params = scene.init_params()
    corners = Camera(aspect=1.0).corner_rays_flat()
    px, py = pixel_grid(RELAXED.width, RELAXED.height)
    ch = Vec3.full((RELAXED.height, RELAXED.width), 1.0, 1.0, 1.0)
    a = np.asarray(
        render_sample(scene, params, RELAXED, corners,
                      jnp.uint32(2)).stack(-1))
    b = np.asarray(jax.jit(lambda p: mega.trace_mega_paths(
        scene, p, RELAXED, corners, px, py, jnp.uint32(2), ch,
        n_samples=1).stack(-1))(params))
    np.testing.assert_array_equal(a, b)


def test_tetrahedral_normals_match_central_diff():
    """4-tap tetrahedron normals agree with the 6-tap central difference to
    O(ε) on smooth SDF regions."""
    from raymarchrenderer.render.integrator import get_normal

    scene = sphere_on_floor()
    params, o, d, ones = _primary(scene, CFG)
    t, m, h = march(scene, params, CFG, o, d, ones, ones > 0)
    p = o + d * t
    n6 = get_normal(scene, params, CFG, p)
    n4 = get_normal(scene, params, CFG.replace(normal_taps=4), p)
    dot = np.asarray(n6.dot(n4))[np.asarray(h)]
    assert dot.min() > 0.9999, dot.min()


def test_grad_normals_match_central_diff():
    """normal_taps=0 (exact ∇map via one vjp sweep) agrees with the 6-tap
    central difference to O(ε²) at hit points — it is the stencils' ε→0
    limit, at ~2 map-eval cost inside the shade pass."""
    from raymarchrenderer.render.integrator import get_normal

    scene = sphere_on_floor()
    params, o, d, ones = _primary(scene, CFG)
    t, m, h = march(scene, params, CFG, o, d, ones, ones > 0)
    p = o + d * t
    n6 = get_normal(scene, params, CFG, p)
    n0 = get_normal(scene, params, CFG.replace(normal_taps=0), p)
    dot = np.asarray(n6.dot(n0))[np.asarray(h)]
    assert dot.min() > 0.9999, dot.min()
    # unit length
    ln = np.asarray(n0.dot(n0))[np.asarray(h)]
    np.testing.assert_allclose(ln, 1.0, atol=1e-5)


def test_grad_normals_through_fused_kernel():
    """The vjp-based normal legalizes inside the Pallas kernel (interpret
    backend) and renders a finite image close to the 4-tap one."""
    from raymarchrenderer.kernels.march import render_fused

    scene = sphere_on_floor()
    params = scene.init_params()
    corners = Camera(aspect=1.0).corner_rays_flat()
    cfg = CFG.replace(width=64, height=64, relax_omega=1.9)
    a = np.asarray(render_fused(scene, params, cfg.replace(normal_taps=4),
                                corners, jnp.uint32(0), n_samples=4,
                                interpret=True))
    b = np.asarray(render_fused(scene, params, cfg.replace(normal_taps=0),
                                corners, jnp.uint32(0), n_samples=4,
                                interpret=True))
    assert np.isfinite(b).all()
    # same paths except where an O(ε²) normal tweak flips a bounce: the
    # mean must stay put even if isolated pixels diverge (MC variance)
    assert np.abs(a - b).mean() < 5e-3, np.abs(a - b).mean()


def test_relaxed_glass_interior_march():
    """Inside-marching (dist_mult = -1, refraction interiors) under
    relaxation: the |signed distance| unbounding balls stay valid, so the
    render agrees with the classic march."""
    from raymarchrenderer.scene.builtin import glass_demo

    scene = glass_demo()
    params = scene.init_params()
    corners = Camera(aspect=1.0).corner_rays_flat()
    cfg = CFG.replace(max_bounces=8)
    spp = 8
    a = sum(np.asarray(render_sample(scene, params, cfg, corners,
                                     jnp.uint32(s)).stack(-1))
            for s in range(spp)) / spp
    b = sum(np.asarray(render_sample(scene, params,
                                     cfg.replace(relax_omega=1.6), corners,
                                     jnp.uint32(s)).stack(-1))
            for s in range(spp)) / spp
    assert np.abs(a - b).mean() < 2e-2


def test_relaxed_image_close_to_classic():
    """Converged-ish means agree: relaxation changes hit t by O(ε) only."""
    scene = sphere_on_floor()
    params = scene.init_params()
    corners = Camera(aspect=1.0).corner_rays_flat()
    spp = 16
    acc0 = acc1 = 0
    for s in range(spp):
        acc0 = acc0 + np.asarray(render_sample(
            scene, params, CFG, corners, jnp.uint32(s)).stack(-1))
        acc1 = acc1 + np.asarray(render_sample(
            scene, params, RELAXED, corners, jnp.uint32(s)).stack(-1))
    a, b = acc0 / spp, acc1 / spp
    # identical RNG streams + O(ε) hit perturbations → tiny residual
    assert np.abs(a - b).mean() < 5e-3
    # a grazing ray whose O(ε) hit shift flips one bounce between hitting
    # and missing the power-8 emitter leaves an O(emitter/spp) speckle;
    # bound the COUNT of such pixels, not the inevitable magnitude
    assert (np.abs(a - b).max(-1) > 0.35).sum() <= 3
