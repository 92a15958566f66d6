"""Scene IR: JSON node-graph scenes → trace-time-composed JAX functions.

The reference stores scenes as JSON node graphs (`data/scenes/*.scene`) and
compiles them to GLSL source spliced into the kernel (`Graphics.cpp:511-752`).
Here the same JSON is parsed into a static structure (`Scene`) whose graph
*constants* are pulled out into a parameter pytree; evaluating the scene's
`map` / `shade` / `sky` against a pixel batch composes the node functions at
JAX trace time into one fused XLA program.  Structure is static (hashable,
jit-friendly); parameters are leaves (differentiable — inverse rendering gets
gradients w.r.t. every shape/material/light constant for free).

Both reference scene-format generations are supported (SURVEY.md §2 #13):
  * old format (`default.scene`, ...): named/indexed register slots,
    `total_vars`, output bindings `color`/`dir`/`inside`/`hit`, literal
    vec3 inputs; material semantics = gen-1 `RayMarch.glsl` shader library.
  * new format (`simple.scene`): `constants` table + `[node, out]` input
    refs + final `output` node; material semantics = gen-2 `RayMarch2.glsl`
    BRDF library (the `compileNode` path, `Graphics.cpp:412-463`).

Extensions over the reference (documented, not breaking parity):
  * `lights` — explicit sphere lights for next-event estimation / soft
    shadows via light marching (BASELINE config 2).
  * `environment` — constant-power sky (`RayMarch.glsl:101`: 0.015) or an
    equirect env image (the reference's `veranda_1k.hdr` path,
    `Graphics.cpp:287` + `skyColor` `RayMarch.glsl:78-97`).
  * extra SDF primitives (plane/torus/cylinder/capsule, smooth union).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from raymarchrenderer.core.vecmath import Vec3, vselect
from raymarchrenderer.scene.nodes import (
    MATERIAL_NODES, OBJECT_NODES, ShadeCtx, ShaderOut,
    misc_fresnel, shader_diffuse2, shader_glossy2, shader_mix2,
)

# input descriptors (static structure)
_PARAM = "param"   # ('param', param_index)
_VAR = "var"       # ('var', register_key)
_POINT = "point"   # ('point',) — the sample point p (object graphs, -1)
_NODE = "node"     # ('node', node_index, out_index) — new format


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    name: str
    inputs: Tuple[Tuple, ...]          # input descriptors
    outputs: Tuple[Any, ...] = ()      # register keys (old format)


@dataclasses.dataclass(frozen=True)
class MaterialDef:
    mat_id: int
    fmt: str                           # 'old' | 'new'
    nodes: Tuple[NodeSpec, ...]
    bindings: Tuple[Any, Any, Any, Any] = (-1, -1, -1, -1)  # color,dir,inside,hit
    output: int = -1                   # new format: final node index


@dataclasses.dataclass(frozen=True)
class ObjectDef:
    mat_id: int
    nodes: Tuple[NodeSpec, ...]
    distance: Any = 0                  # register key of the distance output


@dataclasses.dataclass(frozen=True)
class Light:
    """Sphere light for NEE/soft shadows (extension; params live in pytree)."""
    index: int


def _as_param(value) -> np.ndarray:
    if isinstance(value, (list, tuple)):
        return np.asarray(value, np.float32)
    return np.asarray(float(value), np.float32)


def _param_to_vec3(a: jnp.ndarray) -> Vec3:
    """Broadcastable Vec3 view of a parameter: (3,) → components, () → splat."""
    if a.ndim == 0:
        return Vec3(a, a, a)
    return Vec3(a[0], a[1], a[2])


class _Parser:
    """Collects graph constants into an ordered parameter list."""

    def __init__(self):
        self.params: List[np.ndarray] = []

    def const(self, value) -> Tuple:
        self.params.append(_as_param(value))
        return (_PARAM, len(self.params) - 1)


def _parse_material(m: dict) -> Tuple[MaterialDef, List[np.ndarray]]:
    p = _Parser()
    if "output" in m:  # new format
        consts = [_as_param(c) for c in m.get("constants", [])]
        nodes = []
        for n in m["nodes"]:
            ins = []
            for ref in n.get("inputs", []):
                a, b = int(ref[0]), int(ref[1])
                ins.append((_PARAM, b) if a == -1 else (_NODE, a, b))
            nodes.append(NodeSpec(n["name"], tuple(ins)))
        mat = MaterialDef(int(m["id"]), "new", tuple(nodes),
                          output=int(m["output"]))
        return mat, consts

    nodes = []
    for n in m["nodes"]:
        ins = []
        for ref in n.get("inputs", []):
            if isinstance(ref, (list, tuple)) or isinstance(ref, float):
                ins.append(p.const(ref))
            else:
                ins.append((_VAR, ref))
        outs = tuple(n.get("outputs", []))
        nodes.append(NodeSpec(n["name"], tuple(ins), outs))
    bind = tuple(m.get(k, -1) for k in ("color", "dir", "inside", "hit"))
    return MaterialDef(int(m["id"]), "old", tuple(nodes), bind), p.params


def _parse_object(o: dict) -> Tuple[ObjectDef, List[np.ndarray]]:
    p = _Parser()
    nodes = []
    for n in o["nodes"]:
        ins = []
        for ref in n.get("inputs", []):
            if isinstance(ref, int) and ref == -1:
                ins.append((_POINT,))
            elif isinstance(ref, (list, tuple)) or isinstance(ref, float):
                ins.append(p.const(ref))
            else:
                ins.append((_VAR, ref))
        nodes.append(NodeSpec(n["name"], tuple(ins), tuple(n.get("outputs", []))))
    return ObjectDef(int(o["matID"]), tuple(nodes), o.get("distance", 0)), p.params


_NEW_FMT_NODES = {
    "shader_diffuse": shader_diffuse2,
    "shader_glossy": shader_glossy2,
    "shader_mix": shader_mix2,
}


@dataclasses.dataclass(frozen=True)
class Scene:
    """Static scene structure.  `init_params()` yields the matching pytree;
    every evaluation method takes (params, ...) so the whole scene is a pure
    function of its parameters — `jax.grad` w.r.t. params is inverse
    rendering."""

    materials: Tuple[MaterialDef, ...]
    objects: Tuple[ObjectDef, ...]
    n_lights: int = 0
    has_env_map: bool = False
    # env sampler filter: "linear" = GL_LINEAR parity (4 bilinear taps,
    # the reference's sampler state); "nearest" = 1 tap, fewer gathers at
    # the cost of hard texel edges in the backdrop
    env_filter: str = "linear"
    # env lookup source: "exact" looks up the full-res texture; "mxu"
    # looks up a solid-angle-prefiltered `env_mxu_res` mip of it with the
    # same filter (GL_LINEAR / GL_NEAREST on the mip).  Misses are the
    # low-frequency background, so the mip trades texture detail for a
    # table that stays in cache; "exact" remains the reference-parity
    # mode.  (The value's name is historical: the mip was once looked up
    # by a matrix-unit contraction.)
    env_gather: str = "exact"
    env_mxu_res: Tuple[int, int] = (32, 64)
    # SH environment sky (bands l<=3): params["env"]["sh"] is a (16, 3)
    # coefficient array — a gather-free env representation (pure FMAs;
    # its adjoint is gather-free too, which is what makes sky
    # RECOVERY by inverse rendering tractable — see core/sh.py)
    has_sh_env: bool = False
    # gen-3 band-filter rows (min_wave, max_wave, power, kind) aligned with
    # `materials` — parsed from each material's optional `spectral` block
    # (`RayMarch3.glsl:251-345` semantics; kind 1 = emitter).  Empty = no
    # scene-authored table; `render.spectral_integrator.band_table()` then
    # derives the neutral default.
    spectral_rows: Tuple[Tuple[float, float, float, int], ...] = ()

    # parse-time initial values (not part of the static hash)
    _init: dict = dataclasses.field(default=None, compare=False, hash=False,
                                    repr=False)

    # -- params ---------------------------------------------------------------
    def init_params(self) -> dict:
        return _to_jnp(self._init)

    # -- id mapping -----------------------------------------------------------
    def mat_index(self, mat_id: int) -> int:
        for i, m in enumerate(self.materials):
            if m.mat_id == mat_id:
                return i
        raise KeyError(f"material id {mat_id} not in scene")

    # -- SDF map ---------------------------------------------------------------
    def map(self, params: dict, p: Vec3, max_dist: float):
        """(dist, mat_index) at p — the generated `map()` fold
        (`Graphics.cpp:705-739` emit → `RayMarch.glsl:224-231`)."""
        shape = jnp.shape(p.x)
        d = jnp.full(shape, max_dist, jnp.float32)
        mid = jnp.full(shape, -1, jnp.int32)
        for oi, obj in enumerate(self.objects):
            di = _eval_object(obj, params["objects"][oi], p)
            take = di < d
            d = jnp.where(take, di, d)
            mid = jnp.where(take, jnp.int32(self.mat_index(obj.mat_id)), mid)
        return d, mid

    def map_dist(self, params: dict, p: Vec3, max_dist: float):
        """Distance-only map: skips the per-object material-id selects —
        the march hot loop only needs the id at the hit point, where one
        full `map` eval recovers it (kernels and normals use this).

        The running min seeds from object 0's distance, NOT a `max_dist`
        splat — one fewer `minimum` per eval on the hottest op in the
        renderer.  Beyond-max_dist distances stay unclamped; the march's
        pre-step `t >= max_dist` miss test (`RayMarch.glsl:233-257`
        semantics) bounds the walk either way, so hit points and images
        are unchanged."""
        if not self.objects:
            return jnp.full(jnp.shape(p.x), max_dist, jnp.float32)
        d = _eval_object(self.objects[0], params["objects"][0], p)
        for oi in range(1, len(self.objects)):
            di = _eval_object(self.objects[oi], params["objects"][oi], p)
            d = jnp.minimum(d, di)
        return d

    # -- shading ----------------------------------------------------------------
    def shade(self, params: dict, ctx: ShadeCtx, mat_index) -> ShaderOut:
        """Evaluate every material graph and select by per-pixel mat index —
        the vectorized equivalent of the generated GLSL switch
        (`//#CASEINSERT`, `Graphics.cpp:69-88`)."""
        shape = jnp.shape(ctx.t)
        out = ShaderOut(Vec3.zeros(shape), Vec3.zeros(shape),
                        Vec3.zeros(shape), Vec3.zeros(shape))
        for i, mat in enumerate(self.materials):
            s = _eval_material(mat, params["materials"][i], ctx)
            take = mat_index == i
            out = ShaderOut(vselect(take, s.color, out.color),
                            vselect(take, s.dir, out.dir),
                            vselect(take, s.inside, out.inside),
                            vselect(take, s.hit, out.hit))
        return out

    def is_emissive(self, i: int) -> bool:
        """True if material i's graph reaches shader_emission (terminal)."""
        return any(n.name == "shader_emission" for n in self.materials[i].nodes)

    # -- sky ---------------------------------------------------------------------
    def sky(self, params: dict, direction: Vec3) -> Vec3:
        """`skyColor` (`RayMarch.glsl:78-113`): equirect env map when present,
        else constant vec3(power).

        The env lookup is BILINEAR, matching the reference's GL sampler
        state on the SOIL-loaded HDR texture (`texture2D(envTex, uv)`,
        `RayMarch.glsl:97` + `Graphics.cpp:287`): horizontal wrap (phi is
        periodic), vertical clamp (poles), texel centers at half-integer
        coordinates (GL_LINEAR footprint)."""
        if self.has_env_map:
            two_pi = 2.0 * np.pi
            phi = jnp.arctan2(direction.z, direction.x)
            phi = jnp.where(phi < 0, phi + two_pi, phi)
            u = phi / two_pi
            v = 1.0 - (direction.y * 0.5 + 0.5)
            return self.sky_uv(params, u, v)
        if self.has_sh_env:
            from raymarchrenderer.core.sh import sh_eval
            return sh_eval(params["env"]["sh"], direction)
        power = params["env"]["power"]
        shape = jnp.shape(direction.x)
        c = jnp.broadcast_to(power, shape)
        return Vec3(c, c, c)

    def sky_uv(self, params: dict, u, v) -> Vec3:
        """The equirect lookup from (u, v) directly — the megakernel's
        deferred-sky banks store packed (u, v) (computed in-kernel with
        `vecmath.atan2_poly`), so the XLA composite skips the direction
        math.  Same GL_LINEAR footprint as `sky`.

        `env_gather="mxu"` looks up the prefiltered `env_mxu_res` table
        (`prefilter_env`) instead of the full-res texture.  The lookup is
        flat 1-D row takes — index math identical to 2-D `img[y, x]`
        advanced indexing (bitwise-equal texels)."""
        img = params["env"]["image"]  # (H, W, 3) linear float32
        if self.env_gather == "mxu":
            img = prefilter_env(img, *self.env_mxu_res)
        h, w = img.shape[0], img.shape[1]
        flat = img.reshape(h * w, 3)
        if self.env_filter == "nearest":
            x0 = jnp.mod(jnp.floor(u * w).astype(jnp.int32), w)
            y0 = jnp.clip(jnp.floor(v * h).astype(jnp.int32), 0, h - 1)
            texel = jnp.take(flat, y0 * w + x0, axis=0)
            return Vec3(texel[..., 0], texel[..., 1], texel[..., 2])
        # GL_LINEAR: sample point in texel units, centers at +0.5.
        # Vertical clamp-to-edge: clamp the SAMPLE POINT so both taps
        # of a pole-adjacent footprint collapse onto the edge row
        # (v=0 must return pure top row, not a half-blend with row 1).
        x = u * w - 0.5
        y = jnp.clip(v * h - 0.5, 0.0, h - 1.0)
        x0f = jnp.floor(x)
        y0f = jnp.floor(y)
        fx = x - x0f
        fy = y - y0f
        x0 = jnp.mod(x0f.astype(jnp.int32), w)          # wrap in phi
        y0 = jnp.clip(y0f.astype(jnp.int32), 0, h - 1)  # clamp at poles
        # ONE take per lookup: a quad-footprint table whose row (y, x)
        # holds the whole 2x2 bilinear footprint (12 floats, phi-wrap +
        # pole-clamp baked into the padding) replaces four takes, texels
        # BITWISE-identical.
        img_pad = jnp.concatenate([img, img[:, :1]], axis=1)
        img_pad = jnp.concatenate([img_pad, img_pad[-1:]], axis=0)
        quad = jnp.concatenate([img_pad[:-1, :-1], img_pad[:-1, 1:],
                                img_pad[1:, :-1], img_pad[1:, 1:]],
                               axis=-1)
        r = jnp.take(quad.reshape(h * w, 12), y0 * w + x0, axis=0)
        t00, t10 = r[..., 0:3], r[..., 3:6]
        t01, t11 = r[..., 6:9], r[..., 9:12]
        fx = fx[..., None]
        fy = fy[..., None]
        texel = ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
                 + (t01 * (1 - fx) + t11 * fx) * fy)
        return Vec3(texel[..., 0], texel[..., 1], texel[..., 2])

    # -- lights (extension) --------------------------------------------------------
    def light(self, params: dict, i: int):
        lp = params["lights"]
        return (_param_to_vec3(lp["pos"][i]), lp["power"][i], lp["radius"][i])


def _to_jnp(tree):
    if isinstance(tree, dict):
        return {k: _to_jnp(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jnp(v) for v in tree]
    return jnp.asarray(tree)


def prefilter_env(img, kh: int, kw: int):
    """Solid-angle-correct box prefilter of an equirect env map to
    (kh, kw, 3) — the mip `env_gather="mxu"` looks up.

    Equirect rows cover solid angle ∝ sin(θ); a plain uv-space box average
    would overweight the poles, so each (kh, kw) block averages its texels
    with sin(θ_row) weights (normalized per block): every table texel is
    the mean radiance over the solid angle it covers.  Target dims shrink
    to the largest divisors of (H, W) ≤ (kh, kw), so blocks are whole
    texels; if the image is already ≤ the target the filter is the
    identity (which makes the table lookup exactly GL-on-the-image —
    the mechanism-parity test uses this).  Cheap enough to recompute per
    composite (one pass over the env texels) — XLA hoists it out of the
    chunk loop as loop-invariant."""
    h, w = img.shape[0], img.shape[1]
    kh = min(kh, h)
    kw = min(kw, w)
    while h % kh:
        kh -= 1
    while w % kw:
        kw -= 1
    if (kh, kw) == (h, w):
        return img
    by, bx = h // kh, w // kw
    # sin(theta) at each source row center; v runs 0 (top pole) -> 1
    theta = (jnp.arange(h, dtype=jnp.float32) + 0.5) * (jnp.pi / h)
    wgt = jnp.sin(theta)[:, None, None]                       # (h, 1, 1)
    num = (img * wgt).reshape(kh, by, kw, bx, 3).sum((1, 3))
    den = jnp.broadcast_to(wgt, (h, w, 1)) \
        .reshape(kh, by, kw, bx, 1).sum((1, 3))
    return num / den


# -----------------------------------------------------------------------------
# graph evaluation
# -----------------------------------------------------------------------------

def _resolve(desc, params, vars_, point=None):
    kind = desc[0]
    if kind == _PARAM:
        return _param_to_vec3(params[desc[1]])
    if kind == _VAR:
        return vars_[desc[1]]
    if kind == _POINT:
        return point
    raise ValueError(f"unresolvable input {desc}")


def _eval_material(mat: MaterialDef, params: Sequence, ctx: ShadeCtx) -> ShaderOut:
    shape = jnp.shape(ctx.t)
    zero = Vec3.zeros(shape)
    if mat.fmt == "new":
        memo: Dict[int, Any] = {}

        def ev(ni: int):
            if ni in memo:
                return memo[ni]
            node = mat.nodes[ni]
            ins = []
            for desc in node.inputs:
                if desc[0] == _PARAM:
                    ins.append(_param_to_vec3(params[desc[1]]))
                else:
                    ins.append(ev(desc[1]))
            if node.name == "misc_fresnel":
                out = misc_fresnel(ctx)[0]
            elif node.name in _NEW_FMT_NODES:
                out = _NEW_FMT_NODES[node.name](ctx, *ins)
            else:
                raise KeyError(f"unknown new-format node {node.name}")
            memo[ni] = out
            return out

        out = ev(mat.output)
        if not isinstance(out, ShaderOut):
            raise ValueError("new-format material output node must be a shader")
        return out

    # old format: sequential register machine
    vars_: Dict[Any, Vec3] = {}
    for node in mat.nodes:
        fn = MATERIAL_NODES[node.name]
        ins = [_resolve(d, params, vars_) for d in node.inputs]
        outs = fn(ctx, *ins)
        for key, val in zip(node.outputs, outs):
            vars_[key] = val

    def bind(key) -> Vec3:
        if isinstance(key, int) and key == -1:
            return zero
        return vars_.get(key, zero)

    color_b, dir_b, inside_b, hit_b = mat.bindings
    return ShaderOut(bind(color_b), bind(dir_b), bind(inside_b), bind(hit_b))


def _eval_object(obj: ObjectDef, params: Sequence, p: Vec3):
    vars_: Dict[Any, Vec3] = {}
    for node in obj.nodes:
        fn = OBJECT_NODES[node.name]
        ins = [_resolve(d, params, vars_, point=p) for d in node.inputs]
        outs = fn(*ins)
        for key, val in zip(node.outputs, outs):
            vars_[key] = val
    return vars_[obj.distance].x


# -----------------------------------------------------------------------------
# loading
# -----------------------------------------------------------------------------

def loads_scene(text: str, env_image: Optional[np.ndarray] = None,
                env_sh: Optional[np.ndarray] = None,
                env_filter: str = "linear",
                env_gather: str = "exact") -> Scene:
    """Parse a `.scene` JSON string (either format generation).

    `env_image`: (H, W, 3) equirect texture sky (`Graphics.cpp:287` slot).
    `env_sh`: (16, 3) l<=3 spherical-harmonic sky coefficients (the
    gather-free representation, `core/sh.py`); an `environment.sh`
    array in the scene JSON does the same declaratively.  The texture
    takes precedence when both are given."""
    doc = json.loads(text)
    mats, mat_params = [], []
    for m in doc.get("materials", []):
        md, pp = _parse_material(m)
        mats.append(md)
        mat_params.append(pp)
    objs, obj_params = [], []
    for o in doc.get("objects", []):
        od, pp = _parse_object(o)
        objs.append(od)
        obj_params.append(pp)

    lights = doc.get("lights", [])
    light_params = {
        "pos": np.asarray([l["pos"] for l in lights], np.float32).reshape(-1, 3),
        "power": np.asarray([l.get("power", 1.0) for l in lights], np.float32),
        "radius": np.asarray([l.get("radius", 0.1) for l in lights], np.float32),
    }

    env = doc.get("environment", {})
    env_params: Dict[str, Any] = {"power": np.float32(env.get("power", 0.015))}
    has_env = env_image is not None
    if has_env:
        env_params["image"] = np.asarray(env_image, np.float32)
    if env_sh is None and "sh" in env:
        env_sh = np.asarray(env["sh"], np.float32)
    has_sh = env_sh is not None and not has_env
    if has_sh:
        sh = np.asarray(env_sh, np.float32)
        if sh.shape != (16, 3):
            raise ValueError(f"env_sh must be (16, 3), got {sh.shape}")
        env_params["sh"] = sh

    # optional gen-3 spectral blocks: {"spectral": {"min_wave", "max_wave",
    # "power", "kind"}} per material (`RayMarch3.glsl:251-345` band filters;
    # kind 1 = emitter).  If ANY material declares one, materials without a
    # block get the neutral 380-780nm x0.8 surface filter (the `mat_func_1`
    # default) so the row table stays aligned with `materials`.
    spec_rows: Tuple[Tuple[float, float, float, int], ...] = ()
    raw_mats = doc.get("materials", [])
    if any("spectral" in m for m in raw_mats):
        spec_rows = tuple(
            (float(s.get("min_wave", 380.0)), float(s.get("max_wave", 780.0)),
             float(s.get("power", 0.8)), int(s.get("kind", 0)))
            for s in (m.get("spectral", {}) for m in raw_mats))

    init = {"materials": mat_params, "objects": obj_params,
            "lights": light_params, "env": env_params}
    return Scene(tuple(mats), tuple(objs), n_lights=len(lights),
                 has_env_map=has_env, has_sh_env=has_sh,
                 env_filter=env_filter, env_gather=env_gather,
                 spectral_rows=spec_rows, _init=init)


def load_scene(path: str, env_image: Optional[np.ndarray] = None,
               env_sh: Optional[np.ndarray] = None,
               env_filter: str = "linear",
               env_gather: str = "exact") -> Scene:
    with open(path) as f:
        return loads_scene(f.read(), env_image, env_sh=env_sh,
                           env_filter=env_filter, env_gather=env_gather)
