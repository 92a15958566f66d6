"""Scene IR tests: parsing both reference formats, map/shade evaluation,
parameter pytree structure, builder round-trip."""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np

from raymarchrenderer.core.rng import RNGStream
from raymarchrenderer.core.vecmath import Vec3
from raymarchrenderer.scene import builtin, load_scene, loads_scene
from raymarchrenderer.scene.nodes import ShadeCtx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference's scene files as ported into the repo (both formats)
REF_SCENES = sorted(glob.glob(os.path.join(REPO, "data", "scenes",
                                           "*.scene")))


def _vec(shape, x, y, z):
    return Vec3.full(shape, x, y, z)


def _ctx(shape=(4,)):
    rng = RNGStream(0, jnp.zeros(shape, jnp.uint32),
                    jnp.zeros(shape, jnp.uint32), 0)
    return ShadeCtx(
        origin=_vec(shape, 0, 2, -3), dir=_vec(shape, 0, 0, 1),
        t=jnp.full(shape, 2.0), hit=_vec(shape, 0, 2, -1),
        inside=jnp.zeros(shape, jnp.float32),
        normal=_vec(shape, 0, 1, 0), channels=_vec(shape, 1, 1, 1), rng=rng)


class TestParsing:
    def test_all_reference_scenes_parse(self):
        assert REF_SCENES, "reference scenes missing"
        for path in REF_SCENES:
            s = load_scene(path)
            assert len(s.materials) >= 1
            p = s.init_params()
            assert len(p["materials"]) == len(s.materials)

    def test_scene_hashable_static(self):
        s = builtin.sphere_on_floor()
        assert hash(s) == hash(builtin.sphere_on_floor())

    def test_builder_roundtrip_json(self):
        s = builtin.csg_demo()
        assert s.n_lights == 1
        assert len(s.objects) == 4


class TestMap:
    def test_map_sphere_distance(self):
        s = builtin.sphere_on_floor()
        p = s.init_params()
        pt = _vec((1,), 0.0, 3.0, 0.0)  # 1 above unit sphere at (0,1,0)
        d, mid = s.map(p, pt, 1000.0)
        assert np.isclose(float(d[0]), 1.0, atol=1e-5)
        assert int(mid[0]) == 2  # the ball material index

    def test_map_floor(self):
        s = builtin.sphere_on_floor()
        p = s.init_params()
        pt = _vec((1,), 20.0, 5.0, 20.0)
        d, mid = s.map(p, pt, 1000.0)
        assert np.isclose(float(d[0]), 4.975, atol=1e-5)  # box top at y=0.025
        assert int(mid[0]) == 1

    def test_map_miss(self):
        s = builtin.single_sphere()
        p = s.init_params()
        pt = _vec((1,), 500.0, 500.0, 500.0)
        d, mid = s.map(p, pt, 100.0)
        assert float(d[0]) > 99.0 or int(mid[0]) == 0  # sphere is only obj

    def test_csg_subtract(self):
        s = builtin.csg_demo()
        p = s.init_params()
        # inside the carved sphere region of object 1 the distance is
        # max(box, -sphere) — point at the sphere centre is outside the CSG
        pt = _vec((1,), -2.2, 1.6, -0.6)
        d, _ = s.map(p, pt, 1000.0)
        assert float(d[0]) > 0.0

    def test_reference_default_scene_map(self):
        s = load_scene(os.path.join(os.path.dirname(REF_SCENES[0]),
                                    "default.scene"))
        p = s.init_params()
        pt = _vec((1,), 0.0, 10.0, 0.0)
        d, mid = s.map(p, pt, 1000.0)
        assert np.isfinite(float(d[0]))


class TestShade:
    def test_diffuse_material(self):
        s = builtin.sphere_on_floor()
        p = s.init_params()
        ctx = _ctx()
        out = s.shade(p, ctx, jnp.full((4,), 1, jnp.int32))  # floor: diffuse
        assert np.allclose(np.asarray(out.color.x), 0.8)
        # bounce directions in the normal hemisphere
        assert float(jnp.min(out.dir.dot(ctx.normal))) >= -1e-5

    def test_emission_terminates(self):
        s = builtin.sphere_on_floor()
        p = s.init_params()
        ctx = _ctx()
        out = s.shade(p, ctx, jnp.zeros((4,), jnp.int32))  # emitter
        assert np.allclose(np.asarray(out.color.x), 8.0)  # 1.0 * power 8
        assert np.allclose(np.asarray(out.dir.x), 0.0)    # dir==0 → break

    def test_glass_inside_tracking(self):
        s = builtin.glass_demo()
        p = s.init_params()
        ctx = _ctx()
        out = s.shade(p, ctx, jnp.full((4,), 1, jnp.int32))  # glass
        # entering from outside: some paths set inside=1 (refraction branch)
        assert np.asarray(out.inside.x).max() >= 0.0

    def test_new_format_simple_scene(self):
        s = loads_scene(open(os.path.join(os.path.dirname(REF_SCENES[0]),
                                          "simple.scene")).read())
        p = s.init_params()
        ctx = _ctx()
        out = s.shade(p, ctx, jnp.zeros((4,), jnp.int32))
        assert np.all(np.isfinite(np.asarray(out.color.stack())))
        assert np.all(np.isfinite(np.asarray(out.dir.stack())))

    def test_params_are_differentiable_leaves(self):
        s = builtin.single_sphere()
        p = s.init_params()

        def loss(params):
            pt = _vec((1,), 0.0, 3.0, 0.0)
            d, _ = s.map(params, pt, 1000.0)
            return d[0]

        g = jax.grad(loss)(p)
        # gradient w.r.t. the sphere radius param is -1
        radius_grad = g["objects"][0][1]
        assert np.isclose(float(np.asarray(radius_grad)[0]), -1.0, atol=1e-5)


class TestSky:
    def test_constant_sky(self):
        s = builtin.sphere_on_floor()
        p = s.init_params()
        c = s.sky(p, _vec((2,), 0, 1, 0))
        assert np.allclose(np.asarray(c.x), 0.015)

    def test_env_map_lookup(self):
        img = np.zeros((8, 16, 3), np.float32)
        img[0, :, 0] = 1.0   # top row red
        b = builtin.SceneBuilder()
        m = b.diffuse([0.5, 0.5, 0.5])
        b.sphere(m, [0, 0, 0], 1.0)
        s = b.build(env_image=img)
        p = s.init_params()
        up = s.sky(p, _vec((1,), 0, 1, 0))     # +y → v=0 → top row
        down = s.sky(p, _vec((1,), 0, -1, 0))
        assert float(up.x[0]) == 1.0 and float(up.y[0]) == 0.0
        assert float(down.x[0]) == 0.0

    def test_env_map_bilinear_filtering(self):
        """GL_LINEAR parity (`texture2D`, `RayMarch.glsl:97`): a direction
        whose v lands midway between two texel-row centers blends them
        50/50; exact centers return exact texels."""
        h, w = 8, 16
        img = np.zeros((h, w, 3), np.float32)
        img[3, :, 0] = 1.0     # row 3 red
        img[4, :, 2] = 1.0     # row 4 blue
        b = builtin.SceneBuilder()
        m = b.diffuse([0.5, 0.5, 0.5])
        b.sphere(m, [0, 0, 0], 1.0)
        s = b.build(env_image=img)
        p = s.init_params()

        def dir_for_v(v):
            # v = 1 - (y*0.5+0.5)  →  y = 1 - 2v; keep (x,z) on the unit
            # circle so phi is well-defined
            y = 1.0 - 2.0 * v
            r = np.sqrt(max(0.0, 1.0 - y * y)) or 1e-6
            return _vec((1,), r, y, 0.0)

        # texel-row centers: v = (row + 0.5)/h
        c3 = s.sky(p, dir_for_v(3.5 / h))
        assert abs(float(c3.x[0]) - 1.0) < 1e-5 and float(c3.z[0]) < 1e-5
        # midway between rows 3 and 4: 50/50 red/blue
        mid = s.sky(p, dir_for_v(4.0 / h))
        assert abs(float(mid.x[0]) - 0.5) < 1e-5
        assert abs(float(mid.z[0]) - 0.5) < 1e-5
        # quarter blend
        q = s.sky(p, dir_for_v(3.75 / h))
        assert abs(float(q.x[0]) - 0.75) < 1e-5
        assert abs(float(q.z[0]) - 0.25) < 1e-5

    def test_env_map_wraps_horizontally(self):
        """phi is periodic: a direction just left of the u=0 seam blends
        the LAST column with the first (GL_REPEAT), not a clamped edge."""
        h, w = 4, 8
        img = np.zeros((h, w, 3), np.float32)
        img[:, 0, 0] = 1.0      # first column red
        img[:, -1, 1] = 1.0     # last column green
        b = builtin.SceneBuilder()
        m = b.diffuse([0.5, 0.5, 0.5])
        b.sphere(m, [0, 0, 0], 1.0)
        s = b.build(env_image=img)
        p = s.init_params()
        # u=0 exactly: x half-texel left of column-0 center → blends
        # columns w-1 and 0 equally
        seam = s.sky(p, _vec((1,), 1.0, 0.0, 1e-9))
        assert abs(float(seam.x[0]) - 0.5) < 1e-4
        assert abs(float(seam.y[0]) - 0.5) < 1e-4


class TestShippedScenes:
    def test_shipped_scenes_match_reference_set(self):
        """Our data/scenes ships a native-format port of every reference
        scene (SURVEY.md §2 #13)."""
        import glob
        import os
        ours = {os.path.basename(p) for p in
                glob.glob(os.path.join(REPO, "data/scenes/*.scene"))}
        refs = {os.path.basename(p) for p in REF_SCENES}
        assert refs <= ours or not refs, refs - ours

    def test_material_test_port_semantics(self):
        """The ported material_test.scene renders identically to loading the
        reference file directly (named vs integer registers are formatting,
        not semantics)."""
        import os

        import jax.numpy as jnp
        import numpy as np

        from raymarchrenderer.core.camera import Camera
        from raymarchrenderer.render.config import RenderConfig
        from raymarchrenderer.render.integrator import render_sample
        ref = [p for p in REF_SCENES if p.endswith("material_test.scene")]
        if not ref:
            import pytest
            pytest.skip("reference scene not mounted")
        a = load_scene(ref[0])
        b = load_scene(os.path.join(REPO, "data/scenes/material_test.scene"))
        cfg = RenderConfig(width=32, height=32, max_steps=64, max_bounces=3,
                           max_dist=100.0)
        corners = Camera(aspect=1.0).corner_rays_flat()
        ia = np.asarray(render_sample(a, a.init_params(), cfg, corners,
                                      jnp.uint32(0)).stack(-1))
        ib = np.asarray(render_sample(b, b.init_params(), cfg, corners,
                                      jnp.uint32(0)).stack(-1))
        np.testing.assert_allclose(ia, ib, atol=1e-6)


class TestSpectralSceneFormat:
    """Gen-3 band materials are data-driven through the `.scene` schema
    (`spectral` blocks, `RayMarch3.glsl:251-345`) — the ACTIVE kernel's
    material model is reachable from scene files, not just `spectral_demo`."""

    def test_spectral_scene_reproduces_demo_bitwise(self):
        """`data/scenes/spectral.scene` loads to the exact `spectral_demo()`
        scene: identical static structure, identical parameter pytree,
        identical band table."""
        from raymarchrenderer.render.spectral_integrator import (
            band_table, spectral_demo)
        demo_scene, demo_params, demo_mats = spectral_demo()
        scene = load_scene(os.path.join(REPO, "data/scenes/spectral.scene"))
        assert scene == demo_scene  # static structure incl. spectral_rows
        params = scene.init_params()
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)), params, demo_params)
        mats = band_table(scene)
        for a, b in zip(mats, demo_mats):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_spectral_rows_parsed_with_defaults(self):
        doc = ('{"materials": ['
               '{"id": 0, "nodes": [{"name": "shader_emission", '
               '"inputs": [[1,1,1],[8,8,8]], "outputs": ["c"]}], '
               '"color": "c", "dir": -1, '
               '"spectral": {"min_wave": 500, "max_wave": 600, '
               '"power": 2.0, "kind": 1}},'
               '{"id": 1, "nodes": [{"name": "shader_diffuse", '
               '"inputs": [[0.8,0.8,0.8]], "outputs": ["c","d"]}], '
               '"color": "c", "dir": "d"}], "objects": []}')
        scene = loads_scene(doc)
        assert scene.spectral_rows == (
            (500.0, 600.0, 2.0, 1),       # explicit block
            (380.0, 780.0, 0.8, 0),       # neutral default fill
        )

    def test_no_spectral_blocks_means_empty_rows(self):
        scene = load_scene(os.path.join(REPO, "data/scenes/default.scene"))
        assert scene.spectral_rows == ()

    def test_spectral_scene_renders(self):
        """The loaded spectral scene runs the gen-3 integrator end to end and
        matches the demo render exactly (same scene -> same RNG -> same
        image)."""
        from raymarchrenderer.core.camera import Camera
        from raymarchrenderer.render.config import RenderConfig
        from raymarchrenderer.render.spectral_integrator import (
            band_table, render_spectral, spectral_demo)
        scene = load_scene(os.path.join(REPO, "data/scenes/spectral.scene"))
        cfg = RenderConfig(width=16, height=16, max_steps=48, max_bounces=3,
                           max_dist=100.0)
        corners = Camera(aspect=1.0).corner_rays_flat()
        img, n = render_spectral(scene, scene.init_params(),
                                 band_table(scene), cfg, corners, spp=2)
        d_scene, d_params, d_mats = spectral_demo()
        ref, _ = render_spectral(d_scene, d_params, d_mats, cfg, corners,
                                 spp=2)
        np.testing.assert_array_equal(np.asarray(img), np.asarray(ref))
        assert float(jnp.max(img)) > 0.0


def test_env_exact_quad_table_bitwise():
    """Round-5 exact-path speedup: the quad-footprint single-take lookup
    must return BITWISE the texels/values of the four-take GL_LINEAR
    formula (wrap in phi, clamp at poles, centers at +0.5)."""
    import jax.numpy as jnp
    import numpy as np

    from raymarchrenderer.scene import builtin

    rng = np.random.RandomState(3)
    img = rng.uniform(0.0, 2.0, (8, 16, 3)).astype(np.float32)
    b = builtin.SceneBuilder()
    m = b.diffuse([0.5, 0.5, 0.5])
    b.sphere(m, [0, 1, 0], 1.0)
    scene = b.build(env_image=img, env_filter="linear", env_gather="exact")
    params = scene.init_params()
    h, w = 8, 16
    n = 4096
    u = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
    v = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
    got = scene.sky_uv(params, u, v)

    # the reference 4-take formula, including the pole/wrap edge cases
    flat = img.reshape(h * w, 3)
    x = np.asarray(u) * w - 0.5
    y = np.clip(np.asarray(v) * h - 0.5, 0.0, h - 1.0)
    x0f = np.floor(x).astype(np.float32)
    y0f = np.floor(y).astype(np.float32)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    x0 = np.mod(x0f.astype(np.int32), w)
    x1 = np.mod(x0 + 1, w)
    y0 = np.clip(y0f.astype(np.int32), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    t00 = flat[y0 * w + x0]
    t10 = flat[y0 * w + x1]
    t01 = flat[y1 * w + x0]
    t11 = flat[y1 * w + x1]
    want = ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
            + (t01 * (1 - fx) + t11 * fx) * fy).astype(np.float32)
    np.testing.assert_array_equal(
        np.stack([np.asarray(got.x), np.asarray(got.y),
                  np.asarray(got.z)], -1), want)
