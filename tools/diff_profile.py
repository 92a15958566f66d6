"""Ablation timing for the differentiable forward (BASELINE config 5) on
the GPU kernel route.

The train step's cost structure (1024², spp 4, 4 bounces by default):

  A. megakernel forward         — the non-diff speed of light
  B. recording kernel           — ONE launch banks every march residual
                                  (`kernels.record.trace_record_fused`)
  D. diff forward               — B + the XLA shade replay with
                                  reparameterized-march gradients traced
  E. value_and_grad             — D + backward (policy remat: shade
                                  replay, march never re-run)

D−B ≈ XLA replay cost; E−D ≈ backward cost.  Prints one JSON line.
Knobs: DP_SIZE, DP_SPP, DP_BOUNCES, DP_TAPS.  Refuses to run where the
kernel route is not available (kernels/route.py).
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def timeit(fn, *args, reps=3):
    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def main():
    size = int(os.environ.get("DP_SIZE", "1024"))
    spp = int(os.environ.get("DP_SPP", "4"))
    bounces = int(os.environ.get("DP_BOUNCES", "4"))
    taps = int(os.environ.get("DP_TAPS", "4"))

    from raymarchrenderer.core.camera import Camera
    from raymarchrenderer.kernels.march import render_fused
    from raymarchrenderer.kernels.record import trace_record_fused
    from raymarchrenderer.kernels.route import TRITON, kernel_route
    from raymarchrenderer.render.config import RenderConfig
    from raymarchrenderer.render.integrator import render_patch_spp
    from raymarchrenderer.scene.builtin import sphere_on_floor

    if kernel_route() != TRITON:
        raise SystemExit("diff_profile times the GPU kernels; no GPU found")
    scene = sphere_on_floor()
    params = scene.init_params()
    cfg = RenderConfig(width=size, height=size, max_bounces=bounces,
                       relax_omega=1.9, normal_taps=taps)
    corners = Camera(aspect=1.0).corner_rays_flat()
    origin = (jnp.int32(0), jnp.int32(0))
    mpix_spp = size * size * spp / 1e6

    # A: megakernel
    a_fn = jax.jit(lambda p: render_fused(scene, p, cfg, corners,
                                          jnp.uint32(0), n_samples=spp))
    t_a, _ = timeit(a_fn, params)

    # B: the recording kernel alone
    b_fn = jax.jit(lambda p: trace_record_fused(
        scene, p, cfg, corners, origin, (size, size), jnp.uint32(0),
        n_samples=spp)["t"])
    t_b, _ = timeit(b_fn, params)

    # D: diff forward on the recorded marches (no grad)
    def d_fn(p):
        c = render_patch_spp(scene, p, cfg, corners, origin,
                             (size, size), jnp.uint32(0), spp,
                             differentiable=True, march_impl="recorded")
        return jnp.mean(c.stack(-1) ** 2)

    t_d, _ = timeit(jax.jit(d_fn), params)

    # E: full value_and_grad with the march-saving remat policy
    from raymarchrenderer.diff.march import march_save_policy
    d_remat = jax.checkpoint(d_fn, policy=march_save_policy())
    t_e, _ = timeit(jax.jit(jax.value_and_grad(d_remat)), params)

    rep = {
        "size": size, "spp": spp, "bounces": bounces, "normal_taps": taps,
        "device": jax.devices()[0].device_kind,
        "A_megakernel_s": t_a,
        "B_record_kernel_s": t_b,
        "D_diff_fwd_s": t_d,
        "E_value_and_grad_s": t_e,
        "xla_replay_s (D-B)": t_d - t_b,
        "backward_s (E-D)": t_e - t_d,
        "A_mpix_spp_s": mpix_spp / t_a,
        "E_mpix_spp_s": mpix_spp / t_e,
    }
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
