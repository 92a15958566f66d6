"""Primary ray generation: pixel grid → jittered ray directions.

The kernel contract is bilinear corner-ray interpolation with sub-pixel
jitter (`RayMarch3.glsl:534-535` / `RayMarch.glsl:577-578`):

    pos = pix / size
    dir = normalize(bilerp(corners, fx, fy)),  f = pos + jitter/size

with fx sweeping the horizontal corner pairs (ray00→ray10) and fy the
vertical (row 0 = image top).  Reference HEAD instead sweeps the VERTICAL
pair along pix.x — a transpose inconsistent with its own golden renders;
see the deviation note in `core.camera`.  The reference draws two stateful
`rand()` values for the two fx uses; we use one uniform per axis
(sub-pixel jitter statistics are identical on converged images).
"""
from __future__ import annotations

import jax.numpy as jnp

from raymarchrenderer.core.rng import RNGStream
from raymarchrenderer.core.vecmath import Vec3, vlerp


def pixel_grid(width: int, height: int):
    """Integer pixel coordinate arrays of shape (height, width).

    Axis convention: px varies along array axis 1 (row-major width), py along
    axis 0; row 0 is the TOP image row (standard image layout — the saved
    PNG/BMP needs no flip)."""
    py = jnp.broadcast_to(jnp.arange(height, dtype=jnp.int32)[:, None],
                          (height, width))
    px = jnp.broadcast_to(jnp.arange(width, dtype=jnp.int32)[None, :],
                          (height, width))
    return px, py


def primary_rays(corners, px, py, width: int, height: int,
                 rng: RNGStream) -> Vec3:
    """Jittered, *normalized* primary directions for integer pixel coords.

    `corners` = (eye, ray00, ray10, ray01, ray11) as five (3,) arrays
    (the `Graphics::setView` contract, `Graphics.h:133`); ray00=top-left,
    ray10=top-right, ray01=bottom-left, ray11=bottom-right."""
    _, r00, r10, r01, r11 = (Vec3(c[0], c[1], c[2]) for c in corners)
    ux = rng.next()
    uy = rng.next()
    fx = (px.astype(jnp.float32) + ux) / width
    fy = (py.astype(jnp.float32) + uy) / height
    d = vlerp(vlerp(r00, r10, fx), vlerp(r01, r11, fx), fy)
    return d.normalized()


def eye_vec(corners) -> Vec3:
    e = corners[0]
    return Vec3(e[0], e[1], e[2])
