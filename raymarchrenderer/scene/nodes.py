"""The node library: every material / object node type as a pure JAX function.

This is the replacement for the reference's JSON→GLSL string
compiler (`Graphics.cpp:392-509,705-739` splicing text into shader source at
`//#MATFUNCINSERT` / `//#OBJFUNCINSERT` markers).  Instead of generating
source, scene graphs are *composed at JAX trace time*: each node is a pure
function over structure-of-arrays `Vec3` pixels, and evaluating a graph
builds one fused XLA program.  Constants in the graph become leaf arrays of
the scene's parameter pytree, so every material/shape constant is
differentiable for inverse rendering.

Material node semantics follow the gen-1 kernel's shader library
(`RayMarch.glsl:313-479`); the gen-2 BRDF/PDF library
(`RayMarch2.glsl:272-348`) backs the new-format (`compileNode`,
`Graphics.cpp:412-463`) shader nodes.  Object nodes follow
`RayMarch.glsl:121-215`.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import jax.numpy as jnp

from raymarchrenderer.core import sdf
from raymarchrenderer.core.rng import RNGStream
from raymarchrenderer.core.sampling import (
    cosine_hemisphere, ggx_lobe, make_tbn, tbn_apply,
    uniform_sphere_or_hemisphere,
)
from raymarchrenderer.core.vecmath import Vec3, reflect, refract, vlerp, vselect


class ShadeCtx:
    """Per-bounce shading context — the analogue of GLSL `RayData` +
    `PointData` (`RayMarch.glsl:34-41`, `RayMarch2.glsl:33-39`).

    `inside` is a float mask (0/1) like the reference's `ray.inside`
    bool; `normal` is `getNormal(hit)` computed once (the reference calls
    `getNormal` repeatedly at the same point — identical value, we hoist it).
    `rng` hands out statically-numbered counter-based uniforms.
    """

    __slots__ = ("origin", "dir", "t", "hit", "inside", "normal",
                 "channels", "rng")

    def __init__(self, origin: Vec3, dir: Vec3, t, hit: Vec3, inside,
                 normal: Vec3, channels: Vec3, rng: RNGStream):
        self.origin = origin
        self.dir = dir          # incident ray direction (into the surface)
        self.t = t
        self.hit = hit
        self.inside = inside    # float 0/1
        self.normal = normal
        self.channels = channels
        self.rng = rng

    def grayscale(self, c: Vec3):
        """`grayscale` `RayMarch.glsl:306-309`: channel-mask-normalized mean."""
        return c.sum() / self.channels.sum()

    @property
    def wo(self) -> Vec3:
        """Toward-eye direction (`point.dir = -d`, RayMarch2.glsl:440)."""
        return -self.dir


class ShaderOut(NamedTuple):
    """A material node's shader bundle: (color, dir, inside, hit).

    dir == 0-vector means "terminate path" (`RayMarch.glsl:530-533`);
    hit != 0 overrides the next ray origin (volume scatter,
    `RayMarch.glsl:536-552`).
    """
    color: Vec3
    dir: Vec3
    inside: Vec3
    hit: Vec3


def _zeros_like_ctx(ctx: ShadeCtx) -> Vec3:
    return Vec3.zeros(jnp.shape(ctx.t))


# ---------------------------------------------------------------------------
# gen-1 material shader nodes (RayMarch.glsl:313-479) — old scene format
# ---------------------------------------------------------------------------

def shader_diffuse(ctx: ShadeCtx, color: Vec3):
    """`shader_diffuse` RayMarch.glsl:378-387: uniform-hemisphere bounce."""
    out_dir = uniform_sphere_or_hemisphere(ctx.rng.next(), ctx.rng.next(),
                                           ctx.normal)
    return color, out_dir


def shader_glossy(ctx: ShadeCtx, color: Vec3, roughness: Vec3):
    """`shader_glossy` RayMarch.glsl:389-398: lerp(hemisphere, mirror, 1-r).

    The mirror direction reflects about the normal flipped when inside
    (`getNormal(hit) * -(int(inside)*2-1)`)."""
    hemi = uniform_sphere_or_hemisphere(ctx.rng.next(), ctx.rng.next(),
                                        ctx.normal)
    n_f = ctx.normal * -(ctx.inside * 2.0 - 1.0)
    mirror = reflect(ctx.dir, n_f)
    w = 1.0 - ctx.grayscale(roughness * ctx.channels)
    return color, vlerp(hemi, mirror, w)


def shader_refraction(ctx: ShadeCtx, color: Vec3, ior: Vec3,
                      roughness: Vec3 = None):
    """`shader_refraction` RayMarch.glsl:400-427 with inside-tracking.

    Entering: white throughput, refract with 1/ior, inside:=1.
    Exiting: tinted by color, lerp(diffuse, refract(-n, ior), 1-roughness),
    inside:=0.  GLSL's undefined normalize(0) on total internal reflection
    becomes a 0-direction here (safe-normalize), which terminates the path —
    the reference behaves equivalently (NaN pixel discarded by accumulation
    of a black sample)."""
    if roughness is None:
        roughness = Vec3.full(jnp.shape(ctx.t), 0.0, 0.0, 0.0)
    gs_ior = ctx.grayscale(ior * ctx.channels)
    white = Vec3.full(jnp.shape(ctx.t), 1.0, 1.0, 1.0)

    enter_dir = refract(ctx.dir, ctx.normal, 1.0 / gs_ior)
    enter_dir = enter_dir.normalized() * (enter_dir.dot(enter_dir) > 0)

    r_dir = refract(ctx.dir, -ctx.normal, gs_ior)
    r_dir = r_dir.normalized() * (r_dir.dot(r_dir) > 0)
    d_dir = uniform_sphere_or_hemisphere(ctx.rng.next(), ctx.rng.next(),
                                         ctx.normal)
    exit_dir = vlerp(d_dir, r_dir, 1.0 - ctx.grayscale(roughness * ctx.channels))

    is_in = ctx.inside > 0.5
    out_color = vselect(is_in, color, white)
    out_dir = vselect(is_in, exit_dir, enter_dir)
    inv = 1.0 - ctx.inside
    return out_color, out_dir, Vec3(inv, inv, inv)


def shader_volume_scatter(ctx: ShadeCtx, color: Vec3, density: Vec3):
    """`shader_volumeScatter` RayMarch.glsl:429-474, vectorized.

    The reference runs `floor(t*100)` Bernoulli trials of probability
    `den = grayscale(density)/20` and, on the first success, scatters at a
    *uniform* position `rand()*t` along the ray.  The marginal law is
    exactly: scatter with probability 1-(1-den)^floor(t*100), position
    Uniform(0, t).  We sample that closed form — statistically identical,
    without a data-dependent per-lane loop."""
    shape = jnp.shape(ctx.t)
    is_in = ctx.inside > 0.5
    den = ctx.grayscale(density * ctx.channels) / 20.0
    num_points = jnp.floor(ctx.t * 100.0)
    p_scatter = 1.0 - jnp.power(jnp.maximum(1.0 - den, 0.0), num_points)
    u_evt = ctx.rng.next()
    u_pos = ctx.rng.next()
    scatters = is_in & (u_evt < p_scatter)

    hit_pos = ctx.origin + ctx.dir * (u_pos * ctx.t)
    scat_dir = uniform_sphere_or_hemisphere(ctx.rng.next(), ctx.rng.next(),
                                            _zeros_like_ctx(ctx))

    white = Vec3.full(shape, 1.0, 1.0, 1.0)
    one = jnp.ones(shape, jnp.float32)
    zero = jnp.zeros(shape, jnp.float32)

    out_color = vselect(scatters, color, white)
    out_dir = vselect(scatters, scat_dir, ctx.dir)
    # pass-through while outside keeps inside=1 (ray enters the volume);
    # inside pass-through (no scatter) exits: inside=0 (RayMarch.glsl:459-473)
    inside_f = jnp.where(scatters, one, jnp.where(is_in, zero, one))
    out_hit = vselect(scatters, hit_pos, Vec3.zeros(shape))
    return out_color, out_dir, Vec3(inside_f, inside_f, inside_f), out_hit


def shader_emission(ctx: ShadeCtx, color: Vec3, power: Vec3):
    """`shader_emission` RayMarch.glsl:476-479 (no out dir → terminates)."""
    return (color * ctx.grayscale(power * ctx.channels),)


def shader_mix(ctx: ShadeCtx, *args):
    """`shader_mix` RayMarch.glsl:346-376 — stochastic select.

    7-input form: (c1, d1, i1, c2, d2, i2, factor) → (c, d, i)
    5-input form (old scenes without inside): (c1, d1, c2, d2, f) → (c, d).
    r < f takes branch 2; f==0/1 overrides are implied by r ∈ [0,1)."""
    if len(args) == 7:
        c1, d1, i1, c2, d2, i2, fac = args
    elif len(args) == 5:
        c1, d1, c2, d2, fac = args
        i1 = i2 = _zeros_like_ctx(ctx)
    else:
        raise ValueError(f"shader_mix expects 5 or 7 inputs, got {len(args)}")
    f = jnp.clip(ctx.grayscale(fac * ctx.channels), 0.0, 1.0)
    r = ctx.rng.next()
    take2 = r < f
    out = (vselect(take2, c2, c1), vselect(take2, d2, d1),
           vselect(take2, i2, i1))
    return out if len(args) == 7 else out[:2]


def misc_facing(ctx: ShadeCtx):
    """`misc_facing` RayMarch.glsl:314-317:
    clamp(dot(dir*(inside*2-1), normal), 0, 1) broadcast to vec3."""
    s = ctx.inside * 2.0 - 1.0
    f = jnp.clip((ctx.dir * s).dot(ctx.normal), 0.0, 1.0)
    return (Vec3(f, f, f),)


def misc_inside(ctx: ShadeCtx):
    """`misc_inside` RayMarch.glsl:319-322."""
    return (Vec3(ctx.inside, ctx.inside, ctx.inside),)


def misc_fresnel(ctx: ShadeCtx):
    """`misc_fresnel` codegen `Graphics.cpp:461`:
    pow(1 - clamp(dot(normal, wo), 0, 1), 5) * 0.96 + 0.04."""
    c = jnp.clip(ctx.normal.dot(ctx.wo), 0.0, 1.0)
    f = jnp.power(1.0 - c, 5.0) * 0.96 + 0.04
    return (Vec3(f, f, f),)


def math_add(ctx: ShadeCtx, x: Vec3, n: Vec3):
    return (x + n,)


def math_subtract(ctx: ShadeCtx, x: Vec3, n: Vec3):
    return (x - n,)


def math_multiply(ctx: ShadeCtx, x: Vec3, n: Vec3):
    return (x * n,)


def math_divide(ctx: ShadeCtx, x: Vec3, n: Vec3):
    return (x / n,)


def math_sine(ctx: ShadeCtx, x: Vec3):
    return (Vec3(jnp.sin(x.x), jnp.sin(x.y), jnp.sin(x.z)),)


def math_cosine(ctx: ShadeCtx, x: Vec3):
    return (Vec3(jnp.cos(x.x), jnp.cos(x.y), jnp.cos(x.z)),)


# ---------------------------------------------------------------------------
# gen-2 BRDF/PDF shader nodes (RayMarch2.glsl:272-348) — new scene format
# (`compileNode` path, used by data/scenes/simple.scene)
# ---------------------------------------------------------------------------

def shader_diffuse2(ctx: ShadeCtx, color: Vec3) -> ShaderOut:
    """`DiffuseMaterial.samplePDF/weightPDF` (`RayMarch2.glsl:279-295`):
    cosine-weighted local sample mapped through the TBN; weight = color."""
    local = cosine_hemisphere(ctx.rng.next(), ctx.rng.next())
    tbn = make_tbn(ctx.normal)
    shape = jnp.shape(ctx.t)
    return ShaderOut(color, tbn_apply(tbn, local),
                     Vec3.zeros(shape), Vec3.zeros(shape))


def shader_glossy2(ctx: ShadeCtx, color: Vec3, roughness: Vec3) -> ShaderOut:
    """`GlossyMaterial.samplePDF/weightPDF` (`RayMarch2.glsl:326-347`).

    roughness == 0 → perfect mirror.  (The reference multiplies even the
    mirror branch by the TBN — `Graphics.cpp:423` — which mis-frames it; we
    reflect the *incident* direction in world space, the evident intent.)"""
    r = ctx.grayscale(roughness * ctx.channels)
    lobe = ggx_lobe(ctx.rng.next(), ctx.rng.next(), r)
    tbn = make_tbn(ctx.normal)
    rough_dir = tbn_apply(tbn, lobe)
    mirror = reflect(ctx.dir, ctx.normal)
    out_dir = vselect(r == 0.0, mirror, rough_dir)
    shape = jnp.shape(ctx.t)
    return ShaderOut(color, out_dir, Vec3.zeros(shape), Vec3.zeros(shape))


def shader_mix2(ctx: ShadeCtx, a: ShaderOut, b: ShaderOut,
                factor: Vec3) -> ShaderOut:
    """new-format mix (`compileNode` `Graphics.cpp:426-457`): r <= f → b."""
    f = jnp.clip(ctx.grayscale(factor * ctx.channels), 0.0, 1.0)
    take_b = ctx.rng.next() <= f
    return ShaderOut(vselect(take_b, b.color, a.color),
                     vselect(take_b, b.dir, a.dir),
                     vselect(take_b, b.inside, a.inside),
                     vselect(take_b, b.hit, a.hit))


# ---------------------------------------------------------------------------
# object (SDF) nodes — RayMarch.glsl:121-215
# ---------------------------------------------------------------------------
# Object node convention: vec3-valued registers like the reference's
# generated code (`map_sphere(p, c, r, out vec3 d)` writes vec3(dist)).
# The sample point p arrives as a resolved `-1` input (the reference's
# convention, `Graphics.cpp:94-113`); nodes take exactly their JSON inputs.

def map_sphere(p: Vec3, centre: Vec3, radius: Vec3):
    d = sdf.sd_sphere(p, centre, radius.x)
    return (Vec3(d, d, d),)


def map_box(p: Vec3, centre: Vec3, radius: Vec3):
    d = sdf.sd_box(p, centre, radius)
    return (Vec3(d, d, d),)


def map_plane(p: Vec3, normal: Vec3, offset: Vec3):
    d = sdf.sd_plane(p, normal.normalized(), offset.x)
    return (Vec3(d, d, d),)


def map_torus(p: Vec3, centre: Vec3, radii: Vec3):
    d = sdf.sd_torus(p, centre, radii.x, radii.y)
    return (Vec3(d, d, d),)


def map_cylinder(p: Vec3, centre: Vec3, size: Vec3):
    d = sdf.sd_cylinder(p, centre, size.x, size.y)
    return (Vec3(d, d, d),)


def map_capsule(p: Vec3, a: Vec3, b: Vec3, radius: Vec3):
    d = sdf.sd_capsule(p, a, b, radius.x)
    return (Vec3(d, d, d),)


def op_union(a: Vec3, b: Vec3):
    return (Vec3(*(jnp.minimum(ca, cb) for ca, cb in zip(a, b))),)


def op_subtract(a: Vec3, b: Vec3):
    return (Vec3(*(jnp.maximum(ca, -cb) for ca, cb in zip(a, b))),)


def op_intersect(a: Vec3, b: Vec3):
    return (Vec3(*(jnp.maximum(ca, cb) for ca, cb in zip(a, b))),)


def op_smooth_union(a: Vec3, b: Vec3, k: Vec3):
    d = sdf.smin(a.x, b.x, k.x)
    return (Vec3(d, d, d),)


def domain_repeat(p: Vec3, m: Vec3):
    return (sdf.domain_repeat(p, m),)


def misc_getX(v: Vec3):
    return (Vec3(v.x, v.x, v.x),)


def misc_getY(v: Vec3):
    return (Vec3(v.y, v.y, v.y),)


def misc_getZ(v: Vec3):
    return (Vec3(v.z, v.z, v.z),)


def obj_math_add(x: Vec3, n: Vec3):
    return (x + n,)


def obj_math_subtract(x: Vec3, n: Vec3):
    return (x - n,)


def obj_math_multiply(x: Vec3, n: Vec3):
    return (x * n,)


def obj_math_divide(x: Vec3, n: Vec3):
    return (x / n,)


def obj_math_sine(x: Vec3):
    return (Vec3(jnp.sin(x.x), jnp.sin(x.y), jnp.sin(x.z)),)


def obj_math_cosine(x: Vec3):
    return (Vec3(jnp.cos(x.x), jnp.cos(x.y), jnp.cos(x.z)),)


MATERIAL_NODES: Dict[str, Callable] = {
    "shader_diffuse": shader_diffuse,
    "shader_glossy": shader_glossy,
    "shader_refraction": shader_refraction,
    "shader_volumeScatter": shader_volume_scatter,
    "shader_emission": shader_emission,
    "shader_mix": shader_mix,
    "misc_facing": misc_facing,
    "misc_inside": misc_inside,
    "misc_fresnel": misc_fresnel,
    "math_add": math_add,
    "math_subtract": math_subtract,
    "math_multiply": math_multiply,
    "math_divide": math_divide,
    "math_sine": math_sine,
    "math_cosine": math_cosine,
}

OBJECT_NODES: Dict[str, Callable] = {
    "map_sphere": map_sphere,
    "map_box": map_box,
    "map_plane": map_plane,
    "map_torus": map_torus,
    "map_cylinder": map_cylinder,
    "map_capsule": map_capsule,
    "op_union": op_union,
    "op_subtract": op_subtract,
    "op_intersect": op_intersect,
    "op_smooth_union": op_smooth_union,
    "domain_repeat": domain_repeat,
    "misc_getX": misc_getX,
    "misc_getY": misc_getY,
    "misc_getZ": misc_getZ,
    "math_add": obj_math_add,
    "math_subtract": obj_math_subtract,
    "math_multiply": obj_math_multiply,
    "math_divide": obj_math_divide,
    "math_sine": obj_math_sine,
    "math_cosine": obj_math_cosine,
}
