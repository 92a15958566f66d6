"""Programmatic scene construction + canonical built-in scenes.

`SceneBuilder` is the Python-native front door (supersedes hand-editing
`.scene` JSON): it assembles an old-format scene document and runs it through
the same parser as file loading, so built scenes and loaded scenes are one
code path.

Built-ins:
  * `sphere_on_floor()` — BASELINE config 1: one diffuse sphere on a floor
    box under a sphere emitter; the RGB twin of the gen-3 hardcoded scene
    (`RayMarch3.glsl:132-143`: 32×0.05×32 floor box, unit sphere at (0,1,0),
    radius-4 power-8 emitter at (6,8,−4)).
  * `csg_demo()` — BASELINE config 2: union/subtract/intersect CSG shapes,
    glossy material, sphere light for soft shadows.
  * `cornell()` — classic box for GI convergence tests (config 3).
  * `nee_demo()` / `env_demo()` — the NEE and env-map workloads of
    `bench.py` and `chip_smoke.py`.
  * `glass_demo()` — refraction + inside-tracking (parity scene for
    `glass_test.scene`).
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

from raymarchrenderer.scene.graph import Scene, loads_scene


class SceneBuilder:
    def __init__(self):
        self._materials: List[dict] = []
        self._objects: List[dict] = []
        self._lights: List[dict] = []
        self._env: dict = {}

    # -- materials (gen-1 node-library semantics) -----------------------------
    def _add_material(self, nodes, **bindings) -> int:
        mid = len(self._materials)
        self._materials.append({"id": mid, "nodes": nodes, **bindings})
        return mid

    def diffuse(self, color: Sequence[float]) -> int:
        return self._add_material(
            [{"name": "shader_diffuse", "inputs": [list(color)],
              "outputs": ["color", "dir"]}],
            color="color", dir="dir")

    def emission(self, color: Sequence[float], power: float) -> int:
        return self._add_material(
            [{"name": "shader_emission",
              "inputs": [list(color), [power] * 3], "outputs": ["color"]}],
            color="color", dir=-1)

    def glossy(self, color: Sequence[float], roughness: float) -> int:
        return self._add_material(
            [{"name": "shader_glossy",
              "inputs": [list(color), [roughness] * 3],
              "outputs": ["color", "dir"]}],
            color="color", dir="dir")

    def glossy_diffuse(self, diff_color, gloss_color, roughness) -> int:
        """Fresnel-facing mix of glossy over diffuse — the reference's
        default material pattern (default.scene mat 2)."""
        return self._add_material(
            [{"name": "shader_diffuse", "inputs": [list(diff_color)],
              "outputs": ["dc", "dd"]},
             {"name": "shader_glossy",
              "inputs": [list(gloss_color), [roughness] * 3],
              "outputs": ["gc", "gd"]},
             {"name": "misc_facing", "outputs": ["f"]},
             {"name": "shader_mix",
              "inputs": ["gc", "gd", [0, 0, 0], "dc", "dd", [0, 0, 0], "f"],
              "outputs": ["color", "dir", "inside"]}],
            color="color", dir="dir", inside="inside")

    def glass(self, color, ior: float, roughness: float = 0.02) -> int:
        """Refraction/glossy fresnel mix (glass_test.scene mat 1)."""
        return self._add_material(
            [{"name": "shader_refraction",
              "inputs": [list(color), [ior] * 3, [roughness] * 3],
              "outputs": [0, 1, 2]},
             {"name": "shader_glossy",
              "inputs": [list(color), [roughness] * 3], "outputs": [3, 4]},
             {"name": "misc_facing", "outputs": [5]},
             {"name": "misc_inside", "outputs": [6]},
             {"name": "math_add", "inputs": [5, 6], "outputs": [7]},
             {"name": "shader_mix", "inputs": [3, 4, [0, 0, 0], 0, 1, 2, 7],
              "outputs": [8, 9, 10]}],
            color=8, dir=9, inside=10)

    def volume(self, color, density: float) -> int:
        return self._add_material(
            [{"name": "shader_volumeScatter",
              "inputs": [list(color), [density] * 3],
              "outputs": [0, 1, 2, 3]}],
            color=0, dir=1, inside=2, hit=3)

    # -- objects ---------------------------------------------------------------
    def _add_object(self, mat_id: int, nodes, distance=0):
        self._objects.append({"matID": mat_id, "nodes": nodes,
                              "distance": distance})

    def _prim(self, mat_id: int, name: str, *inputs):
        self._add_object(mat_id, [{"name": name,
                                   "inputs": [-1] + [list(i) for i in inputs],
                                   "outputs": [0]}])

    def sphere(self, mat: int, centre, radius: float):
        self._prim(mat, "map_sphere", centre, [radius] * 3)

    def box(self, mat: int, centre, half_extent):
        self._prim(mat, "map_box", centre, half_extent)

    def plane(self, mat: int, normal, offset: float):
        self._prim(mat, "map_plane", normal, [offset] * 3)

    def torus(self, mat: int, centre, major: float, minor: float):
        self._prim(mat, "map_torus", centre, [major, minor, 0.0])

    def csg(self, mat: int, op: str, prim_a, prim_b, k: float = 0.25):
        """CSG combine two primitive specs ('sphere'|'box', centre, size).

        op ∈ union|subtract|intersect|smooth_union
        (`RayMarch.glsl:183-196`, smin `:115-119`)."""
        def node_of(spec, out):
            kind, centre, size = spec
            name = {"sphere": "map_sphere", "box": "map_box"}[kind]
            size = [size] * 3 if isinstance(size, (int, float)) else list(size)
            return {"name": name, "inputs": [-1, list(centre), size],
                    "outputs": [out]}

        op_node = {"name": f"op_{op}", "inputs": [0, 1], "outputs": [2]}
        if op == "smooth_union":
            op_node["inputs"] = [0, 1, [k] * 3]
        self._add_object(mat, [node_of(prim_a, 0), node_of(prim_b, 1),
                               op_node], distance=2)

    # -- spectral (gen-3) ------------------------------------------------------
    def spectral_band(self, mat_id: int, min_wave: float, max_wave: float,
                      power: float, kind: int = 0):
        """Attach a gen-3 `ColorRange` band filter to a material
        (`RayMarch3.glsl:251-345`; kind 1 = emitter).  Serialized as the
        material's `spectral` block in the `.scene` JSON."""
        self._materials[mat_id]["spectral"] = {
            "min_wave": min_wave, "max_wave": max_wave,
            "power": power, "kind": kind}

    # -- lights / env ------------------------------------------------------------
    def light(self, pos, power: float, radius: float = 0.1):
        self._lights.append({"pos": list(pos), "power": power,
                             "radius": radius})

    def sky(self, power: float):
        self._env["power"] = power

    # -- finish --------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"materials": self._materials,
                           "objects": self._objects,
                           "lights": self._lights,
                           "environment": self._env})

    def build(self, env_image=None, env_filter: str = "linear",
              env_gather: str = "exact") -> Scene:
        return loads_scene(self.to_json(), env_image,
                           env_filter=env_filter, env_gather=env_gather)


# -----------------------------------------------------------------------------
# canonical scenes
# -----------------------------------------------------------------------------

def sphere_on_floor() -> Scene:
    """RGB twin of the gen-3 hardcoded scene (`RayMarch3.glsl:132-143`),
    carrying the gen-3 band table (`:251-345`) as scene-authored spectral
    blocks: power-8 380-780nm sphere emitter (`mat_func_0`), x0.8 380-780nm
    floor (`mat_func_1`), x0.8 490-590nm ball (`mat_func_2`).  Serialized
    form: `data/scenes/spectral.scene`."""
    b = SceneBuilder()
    m_emit = b.emission([1.0, 1.0, 1.0], 8.0)
    m_floor = b.diffuse([0.8, 0.8, 0.8])
    m_ball = b.diffuse([0.2, 0.8, 0.3])
    b.spectral_band(m_emit, 380.0, 780.0, 8.0, kind=1)
    b.spectral_band(m_floor, 380.0, 780.0, 0.8)
    b.spectral_band(m_ball, 490.0, 590.0, 0.8)
    b.box(m_floor, [0, -0.025, 0], [32, 0.05, 32])
    b.sphere(m_ball, [0, 1, 0], 1.0)
    b.sphere(m_emit, [6, 8, -4], 4.0)
    b.sky(0.015)
    return b.build()


def single_sphere() -> Scene:
    """BASELINE config 1 minimal: one diffuse unit sphere, sky light only."""
    b = SceneBuilder()
    m = b.diffuse([0.8, 0.3, 0.3])
    b.sphere(m, [0, 1, 0], 1.0)
    b.sky(0.5)
    return b.build()


def csg_demo() -> Scene:
    """BASELINE config 2: CSG primitives + specular + sphere light."""
    b = SceneBuilder()
    m_floor = b.diffuse([0.75, 0.75, 0.75])
    m_a = b.glossy_diffuse([0.8, 0.2, 0.2], [0.9, 0.9, 0.9], 0.08)
    m_b = b.glossy([0.85, 0.85, 0.9], 0.02)
    m_c = b.diffuse([0.2, 0.4, 0.8])
    b.box(m_floor, [0, -0.025, 0], [32, 0.05, 32])
    b.csg(m_a, "subtract", ("box", [-2.2, 1, 0], [0.9, 0.9, 0.9]),
          ("sphere", [-2.2, 1.6, -0.6], 0.8))
    b.csg(m_b, "intersect", ("sphere", [0, 1, 0], 1.1),
          ("box", [0, 1, 0], [0.85, 0.85, 0.85]))
    b.csg(m_c, "smooth_union", ("sphere", [2.2, 0.8, 0], 0.8),
          ("sphere", [2.9, 1.4, 0], 0.5), k=0.3)
    b.light([3, 7, -3], 60.0, 0.8)
    b.sky(0.05)
    return b.build()


def cornell() -> Scene:
    """Cornell-style box for GI convergence (BASELINE config 3)."""
    b = SceneBuilder()
    white = b.diffuse([0.73, 0.73, 0.73])
    red = b.diffuse([0.65, 0.05, 0.05])
    green = b.diffuse([0.12, 0.45, 0.15])
    lamp = b.emission([1.0, 1.0, 1.0], 24.0)
    metal = b.glossy([0.9, 0.9, 0.9], 0.05)
    s = 2.0
    b.box(white, [0, -0.05, 0], [s, 0.05, s])          # floor
    b.box(white, [0, 2 * s + 0.05, 0], [s, 0.05, s])   # ceiling
    b.box(white, [0, s, -s - 0.05], [s, s, 0.05])      # back
    b.box(red, [-s - 0.05, s, 0], [0.05, s, s])        # left
    b.box(green, [s + 0.05, s, 0], [0.05, s, s])       # right
    b.box(lamp, [0, 2 * s - 0.01, 0], [0.6, 0.02, 0.6])
    b.box(white, [-0.8, 0.6, -0.6], [0.55, 0.6, 0.55])
    b.sphere(metal, [0.9, 0.55, 0.5], 0.55)
    b.sky(0.0)
    return b.build()


def glass_demo() -> Scene:
    """Refraction + inside-tracking (parity with glass_test.scene)."""
    b = SceneBuilder()
    m_floor = b.diffuse([0.8, 0.8, 0.8])
    m_glass = b.glass([0.8, 0.9, 0.8], 1.45, 0.02)
    m_emit = b.emission([1.0, 1.0, 1.0], 16.0)
    b.box(m_floor, [0, -1.025, 0], [32, 0.05, 32])
    b.box(m_glass, [0, 0.5, 0], [1, 1, 0.05])
    b.sphere(m_emit, [4, 6, -4], 2.0)
    b.sky(0.015)
    return b.build()


def volume_demo() -> Scene:
    """Volume scattering (default.scene mat 3 pattern)."""
    b = SceneBuilder()
    m_floor = b.diffuse([0.8, 0.8, 0.8])
    m_vol = b.volume([0.6, 0.7, 0.9], 1.0)
    m_emit = b.emission([1.0, 1.0, 1.0], 16.0)
    b.box(m_floor, [0, -0.025, 0], [32, 0.05, 32])
    b.sphere(m_vol, [0, 1.2, 0], 1.2)
    b.sphere(m_emit, [5, 7, -4], 2.5)
    b.sky(0.015)
    return b.build()


def nee_demo() -> Scene:
    """Light-sampling workload (NEE + soft shadows, `RayMarch2.glsl:480-
    501` / BASELINE config 2): a ball on a floor under one sphere light."""
    b = SceneBuilder()
    m_floor = b.diffuse([0.8, 0.8, 0.8])
    m_ball = b.diffuse([0.2, 0.8, 0.3])
    b.box(m_floor, [0, -0.025, 0], [32, 0.05, 32])
    b.sphere(m_ball, [0, 1, 0], 1.0)
    b.light([6, 8, -4], 60.0, 0.8)
    b.sky(0.015)
    return b.build()


def env_demo(env_filter: str = "linear", env_gather: str = "mxu") -> Scene:
    """The ball-on-floor geometry under a synthetic 512x1024 gradient
    equirect sky — the reference's `veranda_1k.hdr` slot
    (`Graphics.cpp:287`) at its size, with identical lookup work."""
    v = np.linspace(0.0, 1.0, 512)[:, None, None]
    img = (np.array([0.3, 0.5, 1.0]) * (1 - v)
           + np.array([1.0, 0.6, 0.2]) * v)
    img = np.broadcast_to(img, (512, 1024, 3)).astype(np.float32)
    b = SceneBuilder()
    m_floor = b.diffuse([0.8, 0.8, 0.8])
    m_ball = b.diffuse([0.2, 0.8, 0.3])
    b.box(m_floor, [0, -0.025, 0], [32, 0.05, 32])
    b.sphere(m_ball, [0, 1, 0], 1.0)
    return b.build(env_image=img, env_filter=env_filter,
                   env_gather=env_gather)
