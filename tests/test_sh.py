"""SH environment sky (core/sh.py + Scene.has_sh_env): the gather-free
env representation used for lighting recovery (tools/fit_reference)."""
import jax
import jax.numpy as jnp
import numpy as np

from raymarchrenderer.core.camera import Camera
from raymarchrenderer.core.sh import (bake_latlong, constant_coeffs,
                                          latlong_dirs, sh_eval)
from raymarchrenderer.core.vecmath import Vec3
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import render_sample
from raymarchrenderer.scene.graph import loads_scene

_SCENE = """{
 "materials": [
  {"id": 0, "total_vars": 2,
   "nodes": [{"name": "shader_diffuse", "inputs": [[0.8, 0.8, 0.8]],
              "outputs": ["color", "dir"]}],
   "color": "color", "dir": "dir"}
 ],
 "objects": [
  {"matID": 0, "total_vars": 1,
   "nodes": [{"name": "map_sphere", "inputs": [-1, [0, 0, 0], [1, 1, 1]],
              "outputs": [0]}],
   "distance": 0}
 ]
}"""


class TestShBasics:
    def test_constant_coeffs_reproduce_constant_sky(self):
        c = constant_coeffs(0.25)
        d = latlong_dirs(16, 32)
        v = sh_eval(jnp.asarray(c), d)
        np.testing.assert_allclose(np.asarray(v.x), 0.25, atol=1e-6)
        np.testing.assert_allclose(np.asarray(v.z), 0.25, atol=1e-6)

    def test_band1_lobe_points_at_light(self):
        """A +y band-1 lobe makes the up direction brightest."""
        c = np.zeros((16, 3), np.float32)
        c[0] = 1.0
        c[1] = 1.0   # Y1-1 ~ y
        up = Vec3(jnp.zeros(()), jnp.ones(()), jnp.zeros(()))
        dn = Vec3(jnp.zeros(()), -jnp.ones(()), jnp.zeros(()))
        vu = sh_eval(jnp.asarray(c), up)
        vd = sh_eval(jnp.asarray(c), dn)
        assert float(vu.x) > float(vd.x)

    def test_bake_latlong_matches_direct_eval(self):
        c = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
        img = bake_latlong(c, 8, 16)
        d = latlong_dirs(8, 16)
        v = sh_eval(jnp.asarray(c), d)
        np.testing.assert_allclose(img[..., 1], np.asarray(v.y), atol=1e-6)


class TestShScene:
    def test_scene_renders_with_sh_sky(self):
        scene = loads_scene(_SCENE, env_sh=constant_coeffs(0.5))
        assert scene.has_sh_env and not scene.has_env_map
        params = scene.init_params()
        assert params["env"]["sh"].shape == (16, 3)
        cfg = RenderConfig(width=16, height=16, max_steps=48, max_bounces=2,
                           max_dist=50.0)
        corners = Camera(aspect=1.0).corner_rays_flat()
        img = render_sample(scene, params, cfg, corners,
                            jnp.uint32(0)).stack(-1)
        a = np.asarray(img)
        assert np.isfinite(a).all()
        # corner rays miss the unit sphere -> constant sky 0.5 exactly
        assert abs(float(a[0, 0, 0]) - 0.5) < 1e-6

    def test_sh_json_block(self):
        """environment.sh in the scene JSON is the declarative spelling."""
        import json as _json
        doc = _json.loads(_SCENE)
        doc["environment"] = {"sh": constant_coeffs(0.25).tolist()}
        scene = loads_scene(_json.dumps(doc))
        assert scene.has_sh_env

    def test_sky_gradient_flows_to_sh(self):
        scene = loads_scene(_SCENE, env_sh=constant_coeffs(0.5))
        base = scene.init_params()
        cfg = RenderConfig(width=16, height=16, max_steps=48, max_bounces=2,
                           max_dist=50.0)
        corners = Camera(aspect=1.0).corner_rays_flat()

        def loss(sh):
            p = jax.tree.map(lambda x: x, base)
            p["env"]["sh"] = sh
            img = render_sample(scene, p, cfg, corners, jnp.uint32(0),
                                differentiable=True)
            return jnp.mean(img.stack(-1))

        g = jax.grad(loss)(base["env"]["sh"])
        ga = np.asarray(g)
        assert np.isfinite(ga).all()
        assert abs(ga[0]).max() > 0.0   # DC term surely matters
