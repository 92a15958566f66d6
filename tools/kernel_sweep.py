"""Launch-parameter sweep of the GPU kernels, and each kernel against what
XLA makes of its plain version, on one card.

    python tools/kernel_sweep.py sweep           # launch shapes, schedules
    python tools/kernel_sweep.py xla             # kernel against XLA
    python tools/kernel_sweep.py sweep --quick   # two points, as a check

`sweep` times the spectral headline transport, RGB with NEE and the
recorder at 1024² over blocks (8,16) (16,16) (8,32) (16,32) × warps
{2, 4, 8} at unroll 8 / cadence 4, then over unroll/cadence pairs on the
three best shapes.  It sets the kernel modules' defaults
(`kernels.march.NUM_WARPS`, the recorder's unroll and cadence) for each
point and clears JAX's caches between points.

`xla` times the spectral headline (1024², 128 spp, 512 steps, 16 bounces,
relax 2.0, 4 taps), RGB and RGB-NEE at 128 spp and the recorder at spp 16
against `render.mega`'s plain traces jitted over the whole frame with the
same schedule, and one train step at 1024², spp 16 on the recorded
forward against the oracle march.

Each measurement is one JSON line (cold = first call with compilation,
then the median of three warm calls, Mpix·spp/s from the median); the
card's name and power limit come first.  `--out FILE` appends the lines
to FILE as well.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SIDE = 1024
BLOCKS = ((8, 16), (16, 16), (8, 32), (16, 32))
WARPS = (2, 4, 8)
SCHEDULES = ((8, 4), (16, 8), (32, 16), (16, 0), (32, 0), (64, 16))


def _emit(out, **rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _time(fn, *args, runs=3):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        warm.append(time.perf_counter() - t0)
    return cold, statistics.median(warm)


def _cfg(**kw):
    from raymarchrenderer.render.config import RenderConfig
    base = dict(width=SIDE, height=SIDE, max_steps=512, max_bounces=16,
                relax_omega=2.0, normal_taps=4)
    base.update(kw)
    return RenderConfig(**base)


def _corners():
    from raymarchrenderer.core.camera import Camera
    return Camera(aspect=1.0).corner_rays_flat()


def _kernels(spp, block, unroll, cadence):
    """name -> (jitted kernel call, its argument): the three swept
    workloads at one launch point."""
    import jax
    import jax.numpy as jnp

    from raymarchrenderer.kernels import record
    from raymarchrenderer.kernels.march import (render_fused,
                                                render_fused_spectral)
    from raymarchrenderer.render.spectral_integrator import spectral_demo
    from raymarchrenderer.scene import builtin
    sched = dict(block=block, march_unroll=unroll, regen_cadence=cadence)
    corners = _corners()
    scene_s, params_s, mats = spectral_demo()
    nee = builtin.nee_demo()
    rec = builtin.sphere_on_floor()
    rec_cfg = _cfg(max_bounces=4, relax_omega=1.9)
    record.DEFAULT_MARCH_UNROLL, record.DEFAULT_REGEN_CADENCE = (unroll,
                                                                 cadence)
    return {
        "spectral": (jax.jit(lambda p: render_fused_spectral(
            scene_s, p, mats, _cfg(), corners, jnp.uint32(0),
            n_samples=spp, **sched)), params_s),
        "nee": (jax.jit(lambda p: render_fused(
            nee, p, _cfg(), corners, jnp.uint32(0), n_samples=spp,
            direct_light=True, **sched)), nee.init_params()),
        "record": (jax.jit(lambda p: record.trace_record_fused(
            rec, p, rec_cfg, corners, (0, 0), (SIDE, SIDE), jnp.uint32(0),
            n_samples=spp, block=block)), rec.init_params()),
    }


def sweep(args):
    import jax

    from raymarchrenderer.kernels import march
    shapes = [(b, w) for b in BLOCKS for w in WARPS]
    schedules = SCHEDULES
    if args.quick:
        shapes, schedules = shapes[4:6], schedules[:2]
    # stage 1: launch shape at unroll 8 / cadence 4
    stage = []
    for block, warps in shapes:
        march.NUM_WARPS = warps
        jax.clear_caches()
        for name, (fn, p) in _kernels(args.spp, block, 8, 4).items():
            cold, med = _time(fn, p)
            stage.append((med, name, block, warps))
            _emit(args.out, stage="shape", workload=name, block=block,
                  warps=warps, unroll=8, cadence=4, spp=args.spp,
                  cold_s=cold, median_s=med,
                  mpix_spp_s=SIDE * SIDE * args.spp / med / 1e6)
    # the three shapes with the best summed time over the workloads
    total = {}
    for med, _, block, warps in stage:
        total[(block, warps)] = total.get((block, warps), 0.0) + med
    best = sorted(total, key=total.get)[:3]
    # stage 2: unroll / cadence on the best shapes
    for (block, warps), (unroll, cadence) in itertools.product(best,
                                                               schedules):
        march.NUM_WARPS = warps
        jax.clear_caches()
        for name, (fn, p) in _kernels(args.spp, block, unroll,
                                      cadence).items():
            cold, med = _time(fn, p)
            _emit(args.out, stage="schedule", workload=name, block=block,
                  warps=warps, unroll=unroll, cadence=cadence, spp=args.spp,
                  cold_s=cold, median_s=med,
                  mpix_spp_s=SIDE * SIDE * args.spp / med / 1e6)


def against_xla(args):
    import jax
    import jax.numpy as jnp

    from raymarchrenderer.core.vecmath import Vec3
    from raymarchrenderer.kernels.march import (DEFAULT_LAZY_MISS,
                                                DEFAULT_MARCH_UNROLL,
                                                DEFAULT_REGEN_CADENCE,
                                                render_fused,
                                                render_fused_spectral)
    from raymarchrenderer.kernels.record import trace_record_fused
    from raymarchrenderer.parallel.sharding import (ShardConfig, make_mesh,
                                                    render_replicated_params,
                                                    train_step_sharded)
    from raymarchrenderer.render import mega
    from raymarchrenderer.render.raygen import pixel_grid
    from raymarchrenderer.render.spectral_integrator import spectral_demo
    from raymarchrenderer.scene import builtin

    corners = _corners()
    px, py = pixel_grid(SIDE, SIDE)
    ones = Vec3.full((SIDE, SIDE), 1.0, 1.0, 1.0)
    s0 = jnp.uint32(0)
    sched = dict(march_unroll=DEFAULT_MARCH_UNROLL,
                 lazy_miss=DEFAULT_LAZY_MISS,
                 regen_cadence=DEFAULT_REGEN_CADENCE)
    spp = 4 if args.quick else 128
    pairs = []

    scene, params, mats = spectral_demo()
    cfg = _cfg()
    pairs.append(("spectral-headline", spp, params, jax.jit(
        lambda p: render_fused_spectral(scene, p, mats, cfg, corners, s0,
                                        n_samples=spp)), jax.jit(
        lambda p: mega.trace_mega_spectral(scene, p, mats, cfg, corners,
                                           px, py, s0, n_samples=spp,
                                           **sched).stack(-1))))
    for name, scene, nee in (("rgb", builtin.sphere_on_floor(), False),
                             ("nee", builtin.nee_demo(), True)):
        pairs.append((name, spp, scene.init_params(), jax.jit(
            lambda p, scene=scene, nee=nee: render_fused(
                scene, p, cfg, corners, s0, n_samples=spp,
                direct_light=nee)), jax.jit(
            lambda p, scene=scene, nee=nee: mega.trace_mega_paths(
                scene, p, cfg, corners, px, py, s0, ones, n_samples=spp,
                shade_gate=0.0, direct_light=nee, **sched).stack(-1))))
    rspp = 4 if args.quick else 16
    scene = builtin.sphere_on_floor()
    rcfg = _cfg(max_bounces=4, relax_omega=1.9)
    pairs.append(("record", rspp, scene.init_params(), jax.jit(
        lambda p: trace_record_fused(scene, p, rcfg, corners, (0, 0),
                                     (SIDE, SIDE), s0, n_samples=rspp)),
        jax.jit(lambda p: mega.trace_mega_paths(
            scene, p, rcfg, corners, px, py, s0, ones, n_samples=rspp,
            shade_gate=0.0, record_banks=True, **sched)[1])))
    mesh = make_mesh(ShardConfig(1, 1))
    target = jnp.zeros((SIDE, SIDE, 3), jnp.float32)
    with mesh:
        p_rep = render_replicated_params(scene, scene.init_params(), mesh)
    pairs.append(("train-step", rspp, p_rep, *(
        (lambda p, impl=impl: train_step_sharded(
            scene, p, rcfg, corners, target, mesh, spp=rspp, lr=1e-3,
            march_impl=impl)) for impl in ("recorded", "oracle"))))

    for name, n, p, kernel, plain in pairs:
        with mesh:
            times = {impl: _time(fn, p, runs=2) for impl, fn in
                     (("kernel", kernel), ("xla", plain))}
        (kc, km), (xc, xm) = times["kernel"], times["xla"]
        _emit(args.out, stage="vs_xla", workload=name, spp=n,
              kernel_cold_s=kc, kernel_s=km, xla_cold_s=xc, xla_s=xm,
              speedup=xm / km,
              kernel_mpix_spp_s=SIDE * SIDE * n / km / 1e6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("sweep", "xla"))
    ap.add_argument("--quick", action="store_true",
                    help="two launch points / small spp, as a check")
    ap.add_argument("--spp", type=int, default=16,
                    help="samples per launch in the sweep")
    ap.add_argument("--out", help="also append the JSON lines here")
    args = ap.parse_args(argv)

    import jax

    from raymarchrenderer.utils.cache import enable_persistent_cache
    from raymarchrenderer.utils.profiling import device_report
    if jax.devices()[0].platform != "gpu":
        print("kernel_sweep: needs a GPU", file=sys.stderr)
        return 1
    enable_persistent_cache()
    _emit(args.out, device=device_report())
    (sweep if args.what == "sweep" else against_xla)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
