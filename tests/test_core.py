"""Unit tests for core math: SDF/CSG vs closed form, vector ops, camera,
RNG statistics, sampling distributions, spectral table parity."""
import math

import jax.numpy as jnp
import numpy as np
import pytest

from raymarchrenderer.core import sdf
from raymarchrenderer.core.camera import Camera
from raymarchrenderer.core.color import linear_to_srgb, srgb_to_linear
from raymarchrenderer.core.rng import RNGStream, hash_u32, uniform
from raymarchrenderer.core.sampling import (
    cosine_hemisphere, fresnel_schlick, make_tbn, uniform_sphere,
    uniform_sphere_or_hemisphere,
)
from raymarchrenderer.core.spectral import sample_band, wavelength_to_rgb
from raymarchrenderer.core.vecmath import Vec3, reflect, refract, rotate_axis


def v(x, y, z):
    return Vec3(jnp.float32(x), jnp.float32(y), jnp.float32(z))


class TestSDF:
    def test_sphere_closed_form(self):
        # map_sphere RayMarch3.glsl:115-119
        d = sdf.sd_sphere(v(3, 4, 0), v(0, 0, 0), 2.0)
        assert np.isclose(float(d), 3.0)

    def test_box_outside_inside(self):
        # map_box RayMarch3.glsl:121-125
        c = v(0, 0, 0)
        he = v(1, 1, 1)
        assert np.isclose(float(sdf.sd_box(v(3, 0, 0), c, he)), 2.0)
        assert np.isclose(float(sdf.sd_box(v(0, 0, 0), c, he)), -1.0)
        # corner distance
        assert np.isclose(float(sdf.sd_box(v(2, 2, 2), c, he)),
                          math.sqrt(3.0), atol=1e-6)

    def test_csg_ops(self):
        a, b = jnp.float32(1.0), jnp.float32(-0.5)
        assert float(sdf.op_union(a, b)) == -0.5
        assert float(sdf.op_subtract(a, b)) == 1.0
        assert float(sdf.op_intersect(a, b)) == 1.0

    def test_smin_bounds(self):
        # smooth min is <= hard min and converges to it for distant values
        a, b, k = jnp.float32(1.0), jnp.float32(5.0), 0.5
        s = float(sdf.smin(a, b, k))
        assert s == pytest.approx(1.0, abs=1e-6)
        s2 = float(sdf.smin(jnp.float32(1.0), jnp.float32(1.0), 0.5))
        assert s2 < 1.0

    def test_domain_repeat(self):
        q = sdf.domain_repeat(v(2.5, 7.0, -1.0), v(2.0, 0.0, 0.0))
        assert np.isclose(float(q.x), 2.5 % 2.0 - 1.0)
        assert float(q.y) == 7.0  # period 0 passes through
        assert float(q.z) == -1.0

    def test_torus_cylinder_capsule(self):
        assert np.isclose(float(sdf.sd_torus(v(3, 0, 0), v(0, 0, 0), 2.0, 0.5)),
                          0.5)
        assert np.isclose(float(sdf.sd_cylinder(v(0, 3, 0), v(0, 0, 0), 1.0, 1.0)),
                          2.0)
        assert np.isclose(float(sdf.sd_capsule(v(0, 3, 0), v(0, -1, 0),
                                               v(0, 1, 0), 0.5)), 1.5)


class TestVecMath:
    def test_reflect(self):
        d = v(1, -1, 0).normalized()
        n = v(0, 1, 0)
        r = reflect(d, n)
        assert np.allclose([float(r.x), float(r.y), float(r.z)],
                           np.array([1, 1, 0]) / math.sqrt(2), atol=1e-6)

    def test_refract_straight_through(self):
        d = v(0, -1, 0)
        n = v(0, 1, 0)
        r = refract(d, n, 1.0)
        assert np.allclose([float(r.x), float(r.y), float(r.z)], [0, -1, 0],
                           atol=1e-6)

    def test_refract_tir_is_zero(self):
        d = v(1, -0.05, 0).normalized()
        n = v(0, 1, 0)
        r = refract(d, n, 1.5)  # beyond critical angle exiting dense medium
        assert float(r.x) == 0.0 and float(r.y) == 0.0 and float(r.z) == 0.0

    def test_rotate_axis_reference_handedness(self):
        # The reference's column-major glm quirk makes rotAxis apply the
        # transpose (rotation by -t) of standard Rodrigues (Camera.cpp:31-52).
        p = rotate_axis(v(0, 1, 0), jnp.float32(math.pi / 2), v(1, 0, 0))
        # standard Rodrigues about +Y by +90° sends +X → -Z; reference sends +X → +Z
        assert np.allclose([float(p.x), float(p.y), float(p.z)], [0, 0, 1],
                           atol=1e-6)


class TestCamera:
    def test_default_pose_matches_program_cpp(self):
        cam = Camera()  # Program.cpp:102 defaults
        assert np.allclose(cam.direction,
                           np.array([0, -3, 6]) / np.linalg.norm([0, -3, 6]))

    def test_corner_rays_symmetry(self):
        cam = Camera(eye=(0, 0, 0), direction=(0, 0, 1), aspect=1.0,
                     fov=math.pi / 4)
        eye, r00, r10, r01, r11 = cam.corner_rays()
        # horizontal pairs mirror in x, vertical pairs mirror in y
        assert np.isclose(float(r00.x), -float(r10.x), atol=1e-6)
        assert np.isclose(float(r00.y), float(r10.y), atol=1e-6)
        assert np.isclose(float(r00.y), -float(r01.y), atol=1e-6)
        # all corners look forward
        for r in (r00, r10, r01, r11):
            assert float(r.z) > 0

    def test_handedness_matches_reference_goldens(self):
        """Facing +z with y-up, screen-right is +x: the reference's own
        2015 goldens (`output/*.bmp`) show the default.scene green panel at
        x=-4 on the LEFT of frame from the default pose — the external
        artifact that fixes the mirror ambiguity (tools/reference_parity.py
        asserts the full projection against the BMPs)."""
        cam = Camera(eye=(0, 0, 0), direction=(0, 0, 1), aspect=1.0,
                     fov=math.pi / 4)
        _, r00, r10, r01, r11 = cam.corner_rays()
        assert float(r10.x) > 0  # top-right corner looks toward +x
        assert float(r00.x) < 0  # top-left toward -x
        assert float(r00.y) > 0  # top row looks up

    def test_fov_angle(self):
        cam = Camera(eye=(0, 0, 0), direction=(0, 0, 1), aspect=1.0,
                     fov=math.pi / 2)
        _, r00, _, r01, _ = cam.corner_rays()
        # vertical full angle between bottom and top corners == combined
        # v-rotation; with unnormalized local axes the magnitudes differ but
        # symmetry must hold
        a = np.array([float(r00.x), float(r00.y), float(r00.z)])
        b = np.array([float(r01.x), float(r01.y), float(r01.z)])
        assert np.isclose(a[0], b[0], atol=1e-6)
        assert np.isclose(a[1], -b[1], atol=1e-6)


class TestRNG:
    def test_deterministic(self):
        a = uniform(1, 3, 5, 7, 9)
        b = uniform(1, 3, 5, 7, 9)
        assert float(a) == float(b)

    def test_decorrelated_streams(self):
        px = jnp.arange(4096, dtype=jnp.uint32)
        u1 = uniform(0, px, 0, 0, 1)
        u2 = uniform(0, px, 0, 0, 2)
        assert abs(float(jnp.corrcoef(u1, u2)[0, 1])) < 0.05

    def test_uniformity(self):
        px = jnp.arange(1 << 16, dtype=jnp.uint32)
        u = np.asarray(uniform(42, px, 7, 3, 1))
        assert 0.0 <= u.min() and u.max() < 1.0
        assert abs(u.mean() - 0.5) < 0.005
        assert abs(u.var() - 1 / 12) < 0.005

    def test_stream_counter_advances(self):
        s = RNGStream(0, jnp.uint32(1), jnp.uint32(2), jnp.uint32(3))
        a, b = s.next(), s.next()
        assert float(a) != float(b)

    def test_hash_avalanche(self):
        h1 = hash_u32(jnp.uint32(0), 0, 0, 0)
        h2 = hash_u32(jnp.uint32(1), 0, 0, 0)
        diff = bin(int(h1) ^ int(h2)).count("1")
        assert 8 < diff < 26  # ~16 bits flip on 1-bit input change


class TestSampling:
    def _uniforms(self, n, tag):
        px = jnp.arange(n, dtype=jnp.uint32)
        return (uniform(9, px, 0, 0, tag), uniform(9, px, 0, 0, tag + 100))

    def test_uniform_sphere_on_surface(self):
        u1, u2 = self._uniforms(4096, 1)
        d = uniform_sphere(u1, u2)
        assert np.allclose(np.asarray(d.length()), 1.0, atol=1e-5)
        assert abs(float(d.y.mean())) < 0.05  # symmetric

    def test_hemisphere_aligns_to_normal(self):
        u1, u2 = self._uniforms(4096, 3)
        n = Vec3.full((4096,), 0.0, 0.0, 1.0)
        d = uniform_sphere_or_hemisphere(u1, u2, n)
        assert float(jnp.min(d.dot(n))) >= -1e-5

    def test_zero_normal_passthrough(self):
        u1, u2 = self._uniforms(4096, 5)
        n = Vec3.zeros((4096,))
        d = uniform_sphere_or_hemisphere(u1, u2, n)
        # full sphere: roughly half the samples have negative y
        frac = float(jnp.mean((d.y < 0).astype(jnp.float32)))
        assert 0.4 < frac < 0.6

    def test_cosine_hemisphere_mean(self):
        u1, u2 = self._uniforms(1 << 14, 7)
        d = cosine_hemisphere(u1, u2)
        # E[cos theta] = 2/3 for cosine-weighted
        assert abs(float(d.y.mean()) - 2.0 / 3.0) < 0.01

    def test_tbn_orthonormal(self):
        n = Vec3.full((16,), 0.3, 0.8, 0.52).normalized()
        b, nn, t = make_tbn(n)
        assert np.allclose(np.asarray(b.dot(nn)), 0, atol=1e-5)
        assert np.allclose(np.asarray(b.dot(t)), 0, atol=1e-5)
        assert np.allclose(np.asarray(t.length()), 1, atol=1e-5)

    def test_fresnel_range(self):
        # Graphics.cpp:461 constants
        assert float(fresnel_schlick(jnp.float32(1.0))) == pytest.approx(0.04)
        assert float(fresnel_schlick(jnp.float32(0.0))) == pytest.approx(1.0)


class TestSpectral:
    def test_wavelength_to_rgb_table(self):
        # parity points computed from the GLSL piecewise table
        # (RayMarch3.glsl:447-522)
        cases = {
            0.0: (0, 0, 0),       # "unset" → black
            410.0: (-(410 - 440) / 60 * 0.75, 0, 0.75),  # alpha=(410-380)/40
            470.0: (0, (470 - 440) / 50, 1.0),
            500.0: (0, 1.0, -(500 - 510) / 20),
            550.0: ((550 - 510) / 70, 1.0, 0),
            600.0: (1.0, -(600 - 645) / 65, 0),
            700.0: (1.0, 0, 0),
            740.0: ((780 - 740) / 80, 0, 0),
            800.0: (0, 0, 0),
        }
        for wl, (r, g, b) in cases.items():
            c = wavelength_to_rgb(jnp.float32(wl))
            assert np.allclose([float(c.x), float(c.y), float(c.z)],
                               [r, g, b], atol=1e-5), wl

    def test_sample_band_bins(self):
        # mat_func sampling: 5 nm bins inside [min, max) (RayMarch3.glsl:261-266)
        u = jnp.linspace(0, 0.999, 100)
        wl = np.asarray(sample_band(u, 380.0, 780.0))
        assert wl.min() == 380.0 and wl.max() <= 775.0
        assert np.all(wl % 5 == 0)


class TestColor:
    def test_srgb_roundtrip(self):
        x = jnp.linspace(0, 1, 64)
        y = srgb_to_linear(linear_to_srgb(x))
        assert np.allclose(np.asarray(y), np.asarray(x), atol=1e-5)

    def test_srgb_reference_constants(self):
        # Graphics.cpp:761-786 transfer function
        assert float(linear_to_srgb(jnp.float32(0.0031308))) == pytest.approx(
            0.0031308 * 12.92, rel=1e-4)
        assert float(linear_to_srgb(jnp.float32(1.0))) == pytest.approx(1.0)
