"""Compile-time profile of the recorded-mode train step vs (B, S, L).

Round-3's `dryrun_multichip` spent 3m11s compiling `jit_shard_fn` on the
8-device CPU mesh — the suspect is the recorded forward's per-slot banking
(3·B·S + B·S·L separate loop-carry planes with unrolled select chains).
This tool measures jit trace+compile wall time of the recorded sharded
train step on the CPU backend as (max_bounces, n_samples, n_lights) grow,
so the fix (stacked bank carries, round 4) has before/after evidence.

Run under the CPU backend:
  env -u PYTHONPATH JAX_PLATFORMS=cpu \
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/compile_profile.py
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from raymarchrenderer.core.camera import Camera  # noqa: E402
from raymarchrenderer.render.config import RenderConfig  # noqa: E402
from raymarchrenderer.scene import builtin  # noqa: E402


def scene_with_lights(n_lights):
    b = builtin.SceneBuilder()
    m = b.diffuse([0.7, 0.7, 0.7])
    b.sphere(m, [0, 1, 0], 1.0)
    b.box(m, [0, -0.05, 0], [8, 0.05, 8])
    for i in range(n_lights):
        b.light([3 - i, 6, -3 + i], 40.0, 0.5)
    return b.build()


def time_compile(B, S, L, spp=None):
    """Wall time of trace+lower+compile (not execution) for one recorded
    train step on a fresh (tile=4, spp=2) CPU mesh."""
    from raymarchrenderer.parallel.sharding import (ShardConfig,
                                                        _train_step_fn,
                                                        make_mesh)
    scene = scene_with_lights(L)
    params = scene.init_params()
    cfg = RenderConfig(width=128, height=32, max_steps=64, max_bounces=B,
                       max_dist=100.0)
    corners = Camera(aspect=4.0).corner_rays_flat()
    target = jnp.zeros((32, 128, 3), jnp.float32)
    mesh = make_mesh(ShardConfig(tile=4, spp=2))
    spp = S * 2 if spp is None else spp  # S samples per chip on 2 spp shards
    step = _train_step_fn(scene, cfg, mesh, spp, L > 0, "recorded", True,
                          True)
    t0 = time.perf_counter()
    lowered = step.lower(params, corners, target, jnp.float32(1e-3))
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    lowered.compile()
    t_compile = time.perf_counter() - t0
    return round(t_trace, 2), round(t_compile, 2)


def main():
    rows = []
    for B, S, L in ((2, 1, 0), (4, 1, 0), (8, 1, 0), (16, 1, 0),
                    (4, 2, 0), (4, 4, 0), (8, 4, 0),
                    (4, 2, 1), (4, 2, 2), (8, 2, 2)):
        try:
            tt, tc = time_compile(B, S, L)
            row = {"B": B, "S": S, "L": L, "trace_s": tt, "compile_s": tc}
        except Exception as e:  # noqa: BLE001
            row = {"B": B, "S": S, "L": L, "error": str(e)[:160]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"rows": rows}))


if __name__ == "__main__":
    main()
