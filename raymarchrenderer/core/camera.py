"""Pinhole camera: eye + look dir + aspect + vfov -> four frustum-corner rays.

The whole camera model of the reference is reduced to an eye point plus four
corner ray directions which the kernel bilinearly interpolates per pixel
(`Camera.cpp:54-102` -> `Graphics::setView` -> `RayMarch3.glsl:534-535`).
We keep that contract: `Camera.corner_rays()` returns
(eye, ray00, ray10, ray01, ray11) — first digit horizontal (0 = left),
second vertical (0 = TOP image row) — and ray generation lives in
`raymarchrenderer.render.raygen`.

Deliberate deviation from reference HEAD: HEAD's `calculateRays`
(`Camera.cpp:54-102`) rotates with UNNORMALIZED local axes (`Camera.cpp:25-29`)
and its kernels interpolate the vertical corner pair along the horizontal
pixel axis (`RayMarch3.glsl:535`), which together produce a transposed,
anamorphically-stretched framebuffer — inconsistent with the committed 2015
golden images (normal composition, circular spheres).  The goldens are the
evident intent, so this camera is an EXACT pinhole: orthonormal view basis,
tangent-plane corners (bilinear interpolation of unnormalized corner vectors
followed by normalize reproduces the pinhole projection exactly), with
handedness and orientation fixed BY those goldens — the committed check is
`tools/reference_parity.py`, which renders the reference's own
`default.scene` from the `Program.cpp:102` pose and verifies silhouette
positions/statistics against `output/2015-07-12_23-07.bmp`
(`tests/test_reference_parity.py` runs the downscaled version in CI).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax.numpy as jnp

from .vecmath import Vec3

Corners = Tuple[Vec3, Vec3, Vec3, Vec3, Vec3]  # eye, ray00, ray10, ray01, ray11


@dataclasses.dataclass
class Camera:
    """Mutable host-side camera (zoom/pan/orbit parity with `Camera.cpp:104-137`).

    `eye` and `direction` are python tuples; `corner_rays()` produces jnp
    scalars so the result can feed straight into a jitted render.
    """

    eye: tuple = (0.0, 4.0, -6.0)
    direction: tuple = None  # defaults to normalize(0,-3,6) like Program.cpp:102
    aspect: float = 1.0
    fov: float = math.pi / 4  # vertical FOV (Program.cpp:102)

    def __post_init__(self):
        if self.direction is None:
            self.direction = (0.0, -3.0, 6.0)
        n = math.sqrt(sum(c * c for c in self.direction))
        self.direction = tuple(c / n for c in self.direction)

    # -- orthonormal view frame ------------------------------------------------
    def _frame(self):
        """(right, up, forward) — right-handed screen basis.

        right = world_up x dir (screen-right; falls back to x when looking
        straight up/down), up = dir x right.  The handedness is fixed by the
        reference's own golden renders (`output/*.bmp`): from the default
        pose (`Program.cpp:102`, eye=(0,4,-6) facing +z) the green panel at
        x=-4 appears on the LEFT of every 2015 image, so screen-right is +x
        — i.e. world_up x dir, the physical 'right hand of a viewer facing
        dir'.  (dir x world_up would mirror the frame; see
        tools/reference_parity.py for the committed check.)"""
        d = Vec3.of(self.direction)
        up_w = Vec3.of((0.0, 1.0, 0.0))
        r = up_w.cross(d)
        if float(r.dot(r)) < 1e-12:
            r = Vec3.of((1.0, 0.0, 0.0))
        r = r.normalized()
        u = d.cross(r).normalized()
        return r, u, d

    def corner_rays(self) -> Corners:
        """eye + (ray00, ray10, ray01, ray11): exact pinhole frustum corners.

        ray00=top-left, ray10=top-right, ray01=bottom-left, ray11=bottom-right
        in image space (row 0 = top).  Corners are intentionally UNNORMALIZED:
        bilinear interpolation across the image plane then per-pixel
        normalization (raygen) is the exact pinhole projection.
        """
        r, u, d = self._frame()
        tv = math.tan(self.fov / 2.0)
        th = self.aspect * tv
        ray00 = d - r * th + u * tv
        ray10 = d + r * th + u * tv
        ray01 = d - r * th - u * tv
        ray11 = d + r * th - u * tv
        return Vec3.of(self.eye), ray00, ray10, ray01, ray11

    # -- interactive ops (Camera.cpp:104-137) ---------------------------------
    def zoom(self, amount: float) -> None:
        self.eye = tuple(e + d * amount for e, d in zip(self.eye, self.direction))

    def pan(self, dx: float, dy: float) -> None:
        r, u, _ = self._frame()
        ex = (float(r.x), float(r.y), float(r.z))
        ey = (float(u.x), float(u.y), float(u.z))
        self.eye = tuple(e + ax * dx + ay * dy
                         for e, ax, ay in zip(self.eye, ex, ey))

    def orbit(self, ax: float, ay: float) -> None:
        from .vecmath import rotate_axis
        r, u, _ = self._frame()
        d = Vec3.of(self.direction)
        d = rotate_axis(u, ax, d).normalized()
        d = rotate_axis(r, ay, d).normalized()
        self.direction = (float(d.x), float(d.y), float(d.z))

    def look_at(self, target: tuple) -> None:
        d = tuple(t - e for t, e in zip(target, self.eye))
        n = math.sqrt(sum(c * c for c in d))
        self.direction = tuple(c / n for c in d)

    def corner_rays_flat(self):
        """Corners as five (3,) float32 arrays — convenient for jit args."""
        eye, r00, r10, r01, r11 = self.corner_rays()
        return tuple(jnp.stack([v.x, v.y, v.z]) for v in (eye, r00, r10, r01, r11))
