"""BASELINE config 5 demo: full-frame sharded inverse-rendering train step.

Runs `parallel.sharding.train_step_sharded` — by default on the RECORDED
differentiable forward (`march_impl="recorded"`: the whole multi-bounce
march runs as ONE Pallas launch per card, the XLA side replays only the
shade chain with the implicit adjoint) — at a full 1024²+ frame on the
available mesh (1×1 on a single card; the multi-device sharding of the
same code path is validated by `__graft_entry__.dryrun_multichip` on
virtual devices), and reports the train-step rate next to the forward-only
fused render rate so the backward's cost is an honest multiple, not a
guess.

Knobs: TRAIN_SIZE (default 1024), TRAIN_SPP (default 4), TRAIN_STEPS
(default 3 timed steps), TRAIN_BOUNCES (default 4 — inverse rendering
wants short transport; 16-bounce budgets are a forward-render default),
TRAIN_IMPL (recorded | oracle; recorded needs the GPU kernel route).

Prints one JSON line; `bench.py` stays the driver headline.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh


def main():
    size = int(os.environ.get("TRAIN_SIZE", "1024"))
    spp = int(os.environ.get("TRAIN_SPP", "4"))
    steps = int(os.environ.get("TRAIN_STEPS", "3"))
    bounces = int(os.environ.get("TRAIN_BOUNCES", "4"))
    remat = os.environ.get("TRAIN_REMAT", "1") == "1"
    impl = os.environ.get("TRAIN_IMPL", "recorded")
    taps = int(os.environ.get("TRAIN_NORMAL_TAPS", "4"))

    from raymarchrenderer.core.camera import Camera
    from raymarchrenderer.kernels.march import render_fused
    from raymarchrenderer.parallel.sharding import (
        render_replicated_params, train_loss_sharded, train_step_sharded)
    from raymarchrenderer.render.config import RenderConfig
    from raymarchrenderer.scene.builtin import sphere_on_floor

    from raymarchrenderer.kernels.route import TRITON, kernel_route
    platform = jax.devices()[0].device_kind
    if kernel_route() != TRITON and impl != "oracle":
        raise SystemExit("TRAIN_IMPL=recorded needs a GPU; pass "
                         "TRAIN_IMPL=oracle to time the plain XLA path")
    scene = sphere_on_floor()
    params = scene.init_params()
    cfg = RenderConfig(width=size, height=size, max_bounces=bounces,
                       relax_omega=1.9, normal_taps=taps)
    corners = Camera(aspect=1.0).corner_rays_flat()

    n = len(jax.devices())
    tile = 1
    while n % (tile * 2) == 0 and tile < 4:
        tile *= 2
    mesh = Mesh(np.asarray(jax.devices()).reshape(tile, n // tile),
                ("tile", "spp"))

    # forward-only fused reference rate (same workload, megakernel)
    fwd = jax.jit(lambda p, c, s: render_fused(
        scene, p, cfg, c, s, n_samples=spp))
    jax.block_until_ready(fwd(params, corners, jnp.uint32(0)))
    t0 = time.perf_counter()
    jax.block_until_ready(fwd(params, corners, jnp.uint32(spp)))
    fwd_dt = time.perf_counter() - t0

    # the target: a converged-ish render of perturbed geometry
    target = fwd(params, corners, jnp.uint32(64))

    spectral = os.environ.get("TRAIN_MODE", "rgb") == "spectral"
    if spectral:
        # the spectral train step on the RECORDED forward
        # (TRAIN_IMPL=oracle times the per-bounce XLA path)
        from raymarchrenderer.parallel.sharding import (
            train_step_spectral_sharded)
        from raymarchrenderer.render.spectral_integrator import (
            band_table)
        mats = band_table(scene)

        def step(p, s):
            loss, np_, nm = train_step_spectral_sharded(
                scene, p, mats, cfg, corners, target, mesh, spp=spp,
                lr=1e-3, march_impl=impl, sample0=s * spp)
            return loss, np_

    else:
        def step(p, s):
            return train_step_sharded(scene, p, cfg, corners, target,
                                      mesh, spp=spp, lr=1e-3,
                                      march_impl=impl, remat=remat)

    with mesh:
        # pre-place replicated so step 1 compiles with the same input
        # shardings steady-state steps see (uniform-upload analogue)
        params = render_replicated_params(scene, params, mesh)
        loss, p = step(params, 0)
        jax.block_until_ready((loss, p))  # compile + warmup
        times = []
        for k in range(steps):
            t0 = time.perf_counter()
            loss, p = step(p, k + 1)
            jax.block_until_ready((loss, p))
            times.append(time.perf_counter() - t0)
        # forward HALF of the same program (identical differentiable-mode
        # trace + loss, no grad): the honest backward-overhead denominator
        loss_dt = None
        if not spectral:
            jax.block_until_ready(train_loss_sharded(
                scene, params, cfg, corners, target, mesh, spp=spp,
                march_impl=impl))
            t0 = time.perf_counter()
            jax.block_until_ready(train_loss_sharded(
                scene, p, cfg, corners, target, mesh, spp=spp,
                march_impl=impl))
            loss_dt = time.perf_counter() - t0
    rec_dt = None
    if (impl == "recorded" and not spectral
            and os.environ.get("TRAIN_DECOMP", "0") == "1"):
        # decomposition: time the RECORDING kernel alone — step =
        # recording + XLA replay(fwd) + backward, so (loss_dt - rec_dt)
        # is the replay and (dt - loss_dt) the backward
        from raymarchrenderer.kernels.record import trace_record_fused
        rec = jax.jit(lambda p: trace_record_fused(
            scene, p, cfg, corners, (0, 0), (size, size), jnp.uint32(0),
            n_samples=spp))
        jax.block_until_ready(rec(params))
        t0 = time.perf_counter()
        jax.block_until_ready(rec(params))
        rec_dt = time.perf_counter() - t0
    dt = min(times)
    mpix_spp_s = size * size * spp / dt / 1e6
    fwd_rate = size * size * spp / fwd_dt / 1e6
    loss_rate = (None if loss_dt is None
                 else size * size * spp / loss_dt / 1e6)
    print(json.dumps({
        "metric": "train-step Mpix*spp/s @ %dx%d spp=%d bounces=%d "
                  "(mesh=%dx%d, %s%s)" % (size, size, spp, bounces, tile,
                                          n // tile, platform,
                                          ", spectral" if spectral else ""),
        "value": round(mpix_spp_s, 3),
        "unit": "Mpix*spp/s",
        "forward_fused_mpix_spp_s": round(fwd_rate, 3),
        "forward_loss_mpix_spp_s": (None if loss_rate is None
                                    else round(loss_rate, 3)),
        "train_vs_megakernel_forward": round(fwd_rate / mpix_spp_s, 2),
        "backward_overhead_vs_own_forward": (
            None if loss_rate is None
            else round(loss_rate / mpix_spp_s, 2)),
        "remat": remat,
        "march_impl": impl,
        "loss": round(float(loss), 6),
        "wall_s": round(dt, 3),
        **({} if rec_dt is None else {"decomposition_s": {
            "recording_kernel": round(rec_dt, 4),
            "xla_replay_forward": round(loss_dt - rec_dt, 4),
            "backward_and_update": round(dt - loss_dt, 4),
            "total_step": round(dt, 4)}}),
    }))


if __name__ == "__main__":
    main()
