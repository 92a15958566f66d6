"""Real spherical harmonics (bands l<=3, 16 terms) for environment lighting.

A gather-free environment-light representation: evaluating an equirect
texture per miss direction is a gather (and its gradient a scatter-add),
while an SH sky is 16 fused multiply-adds per channel, fully
vectorizable, and its adjoint is the same basis evaluation transposed.  Lighting recovery (inverse
rendering of the sky, `tools/fit_reference.py`) optimizes SH coefficients
and optionally bakes them to a latlong texture afterwards
(`bake_latlong`) for use with the texture path (`Scene.sky` equirect
branch, `RayMarch.glsl:78-97` semantics).

Basis: the standard real SH with Condon-Shortley-free constants (the
graphics convention, e.g. Ramamoorthi & Hanrahan's irradiance maps).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from raymarchrenderer.core.vecmath import Vec3

N_SH = 16  # bands 0..3


def sh_basis(d: Vec3):
    """The 16 l<=3 real-SH basis functions at unit direction(s) `d`.
    Returns a list of arrays shaped like d.x."""
    x, y, z = d.x, d.y, d.z
    return [
        0.282095 * jnp.ones_like(x),
        0.488603 * y,
        0.488603 * z,
        0.488603 * x,
        1.092548 * x * y,
        1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
        0.590044 * y * (3.0 * x * x - y * y),
        2.890611 * x * y * z,
        0.457046 * y * (5.0 * z * z - 1.0),
        0.373176 * z * (5.0 * z * z - 3.0),
        0.457046 * x * (5.0 * z * z - 1.0),
        1.445306 * z * (x * x - y * y),
        0.590044 * x * (x * x - 3.0 * y * y),
    ]


def sh_eval(coeffs, d: Vec3) -> Vec3:
    """Radiance of an SH sky: coeffs (16, 3) -> non-negative RGB at `d`.
    (Clamped at 0 — an SH expansion of a non-negative radiance map can
    ring negative; emission must stay physical.)"""
    basis = sh_basis(d)
    r = g = b = jnp.zeros_like(d.x)
    for k, bk in enumerate(basis):
        r = r + bk * coeffs[k, 0]
        g = g + bk * coeffs[k, 1]
        b = b + bk * coeffs[k, 2]
    zero = jnp.zeros_like(r)
    return Vec3(jnp.maximum(r, zero), jnp.maximum(g, zero),
                jnp.maximum(b, zero))


def constant_coeffs(value: float) -> np.ndarray:
    """SH coefficients of a constant sky of the given radiance."""
    c = np.zeros((N_SH, 3), np.float32)
    c[0, :] = value / 0.282095
    return c


def latlong_dirs(h: int, w: int):
    """Unit directions of an (h, w) equirect grid, matching the `Scene.sky`
    texture convention (u = phi/2pi with phi = atan2(z, x) wrapped to
    [0, 2pi); v = 1 - (y*0.5 + 0.5), texel centers at half-integers)."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    y = 1.0 - 2.0 * v                       # v = 1 - (y+1)/2
    phi = u * 2.0 * np.pi
    sin_t = np.sqrt(np.maximum(0.0, 1.0 - y * y))
    x = np.cos(phi)[None, :] * sin_t[:, None]
    z = np.sin(phi)[None, :] * sin_t[:, None]
    yy = np.broadcast_to(y[:, None], (h, w))
    return Vec3(jnp.asarray(x, jnp.float32), jnp.asarray(yy, jnp.float32),
                jnp.asarray(z, jnp.float32))


def bake_latlong(coeffs, h: int = 64, w: int = 128) -> np.ndarray:
    """Render SH coefficients to an (h, w, 3) linear latlong texture (the
    recovered-environment artifact; also loadable back through
    `load_scene(..., env_image=...)` for the texture sky path)."""
    d = latlong_dirs(h, w)
    c = sh_eval(jnp.asarray(coeffs), d)
    return np.stack([np.asarray(c.x), np.asarray(c.y), np.asarray(c.z)],
                    axis=-1)
