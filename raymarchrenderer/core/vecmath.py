"""Vector math on structure-of-arrays Vec3.

Design note: rays, normals and colors are kept as three separate
(H, W)-shaped float32 arrays rather than a trailing size-3 axis, so every
elementwise op is fully vectorized and fusable by XLA, and the same code
runs unchanged inside Pallas kernel bodies, where each lane of a 2-D block
is one pixel (no size-3 axis, which Triton could not hold).

Reference parity: `RayMarch Renderer/Vector.h` (Vector2/3/4 double-precision
host math) and the GLSL built-ins used by `RayMarch3.glsl` (normalize, cross,
reflect, refract, mix, clamp).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Vec3(NamedTuple):
    """Structure-of-arrays 3-vector. Components broadcast like jnp arrays."""

    x: jax.Array
    y: jax.Array
    z: jax.Array

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry -----------------------------------------------------------
    def dot(self, o: "Vec3") -> jax.Array:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length(self) -> jax.Array:
        # clamp keeps the sqrt adjoint finite at 0 (0·inf → NaN otherwise
        # when a masked-out lane's cotangent is zero); primal error ≤ 1e-12
        return jnp.sqrt(jnp.maximum(self.dot(self), 1e-24))

    def normalized(self) -> "Vec3":
        # 1e-24 (not tinier): rsqrt' = -x^{-3/2}/2 must stay below f32 inf
        inv = jax.lax.rsqrt(jnp.maximum(self.dot(self), 1e-24))
        return self * inv

    def min_component(self) -> jax.Array:
        return jnp.minimum(self.x, jnp.minimum(self.y, self.z))

    def max_component(self) -> jax.Array:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def sum(self) -> jax.Array:
        return self.x + self.y + self.z

    def abs(self) -> "Vec3":
        return Vec3(jnp.abs(self.x), jnp.abs(self.y), jnp.abs(self.z))

    def maximum(self, o) -> "Vec3":
        if isinstance(o, Vec3):
            return Vec3(jnp.maximum(self.x, o.x), jnp.maximum(self.y, o.y),
                        jnp.maximum(self.z, o.z))
        return Vec3(jnp.maximum(self.x, o), jnp.maximum(self.y, o),
                    jnp.maximum(self.z, o))

    # -- helpers ------------------------------------------------------------
    def astype(self, dt) -> "Vec3":
        return Vec3(self.x.astype(dt), self.y.astype(dt), self.z.astype(dt))

    def stack(self, axis: int = -1) -> jax.Array:
        return jnp.stack([self.x, self.y, self.z], axis=axis)

    @staticmethod
    def full(shape, vx, vy, vz, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.full(shape, vx, dtype),
            jnp.full(shape, vy, dtype),
            jnp.full(shape, vz, dtype),
        )

    @staticmethod
    def of(v) -> "Vec3":
        """From a length-3 sequence / array of scalars."""
        return Vec3(jnp.asarray(v[0], jnp.float32),
                    jnp.asarray(v[1], jnp.float32),
                    jnp.asarray(v[2], jnp.float32))

    @staticmethod
    def from_array(a: jax.Array, axis: int = -1) -> "Vec3":
        xs = jnp.moveaxis(a, axis, 0)
        return Vec3(xs[0], xs[1], xs[2])

    @staticmethod
    def zeros(shape=(), dtype=jnp.float32) -> "Vec3":
        z = jnp.zeros(shape, dtype)
        return Vec3(z, z, z)


def vselect(mask, a: Vec3, b: Vec3) -> Vec3:
    """Per-component jnp.where over Vec3 (GLSL `mix` with a bool mask)."""
    return Vec3(jnp.where(mask, a.x, b.x),
                jnp.where(mask, a.y, b.y),
                jnp.where(mask, a.z, b.z))


def vlerp(a: Vec3, b: Vec3, t) -> Vec3:
    """GLSL mix(a, b, t) = a*(1-t) + b*t."""
    return a * (1.0 - t) + b * t


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """GLSL reflect: d - 2*dot(d,n)*n (d points *into* the surface)."""
    return d - n * (2.0 * d.dot(n))


def refract(d: Vec3, n: Vec3, eta) -> Vec3:
    """GLSL refract(I, N, eta); returns 0-vector on total internal reflection.

    The sqrt argument is floored at 1e-12 (not 0): sqrt' -> inf at 0, and
    the TIR vselect's zero cotangent times that inf is NaN — which would
    poison the gradient of EVERY parameter upstream of any near-TIR
    refraction event (inverse rendering of IOR/roughness/geometry).  The
    floor changes the primal by at most sqrt(1e-12) = 1e-6 on the
    measure-zero k ∈ [0, 1e-12) sliver and keeps every adjoint finite."""
    cosi = -d.dot(n)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    k = jnp.maximum(k, 1e-12)
    out = d * eta + n * (eta * cosi - jnp.sqrt(k))
    return vselect(tir, Vec3.zeros(jnp.shape(tir)), out)


def rotate_axis(u: Vec3, t, p: Vec3) -> Vec3:
    """Rodrigues rotation of point p about unit axis u by angle t.

    Parity with the reference camera's rotation-matrix construction
    (`Camera.cpp:31-52` builds R = cos(t) I + sin(t) [u]_x + (1-cos(t)) u u^T;
    note glm::mat3 is column-major so the reference effectively applies R^T —
    i.e. a rotation by -t of the standard Rodrigues formula.  We reproduce the
    reference's *observed* mapping).
    """
    ct = jnp.cos(t)
    st = jnp.sin(t)
    # Standard Rodrigues: p ct + (u x p) st + u (u.p)(1-ct); the reference's
    # column-major glm quirk flips the sign of the cross term.
    return p * ct - u.cross(p) * st + u * (u.dot(p) * (1.0 - ct))


def make_onb(n: Vec3) -> tuple[Vec3, Vec3, Vec3]:
    """Orthonormal basis around normal n, matching `makeViewMat`
    (`RayMarch3.glsl:63-80`): locZ = n; locX = normalize(cross(n, up)) with a
    (0,0,1) fallback when n == up; locY = normalize(cross(n, locX)).

    Vectorized: the exact-equality branch becomes a where() on |n x up|^2.
    """
    up = Vec3.full(jnp.shape(n.x), 0.0, 1.0, 0.0)
    alt = Vec3.full(jnp.shape(n.x), 0.0, 0.0, 1.0)
    c1 = n.cross(up)
    c2 = n.cross(alt)
    degenerate = c1.dot(c1) < 1e-12
    x = vselect(degenerate, c2, c1).normalized()
    y = n.cross(x).normalized()
    return x, y, n


def atan2_poly(y, x):
    """Polynomial atan2 (max error ~1e-6 rad) from basic elementwise ops —
    the megakernel's deferred-sky bank packs the miss direction as
    equirect (u, v) IN-kernel, where it costs a few FMAs (Rajan et al.
    odd-polynomial minimax on [0,1] + quadrant folding).  1e-6 rad is
    ~2e-4 texels of a 1024-wide env map — far below the 16-bit bank
    quantization it feeds."""
    pi = jnp.float32(3.14159265358979)
    half_pi = jnp.float32(1.5707963267949)
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    hi = jnp.maximum(ax, ay)
    lo = jnp.minimum(ax, ay)
    r = lo / jnp.maximum(hi, jnp.float32(1e-30))
    s = r * r
    # odd minimax coefficients for atan(r), r in [0, 1]
    a = (((((jnp.float32(-0.0117212) * s + jnp.float32(0.05265332)) * s
            - jnp.float32(0.11643287)) * s + jnp.float32(0.19354346)) * s
          - jnp.float32(0.33262347)) * s + jnp.float32(0.99997726)) * r
    a = jnp.where(ay > ax, half_pi - a, a)
    a = jnp.where(x < 0, pi - a, a)
    return jnp.where(y < 0, -a, a)
