"""Smoke test of the renderer on one NVIDIA GPU, through the entry points
a user calls, at the reference's full default workload.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded path only

Phases (one process, one tagged line each; any failure exits non-zero):

  headline   `app.cli.main(["render", "--spectral", ...])`: 1024², 128 spp,
             512 steps, 16 bounces, relax 2.0, 4 normal taps — the
             spectral megakernel; wall, compile and Mpix·spp/s
  rgb        RGB, NEE, dispersion and env-map (deferred composite) renders
             at 1024² through the fused kernel
  parity     every kernel against its plain-jnp reference at 1024², 8 spp,
             on the strict and the production schedule, matmuls at
             "highest" precision
  train      `app.cli.main(["train", ...])` 3 steps at 1024², spp 4 on the
             recorded forward; one step's loss and gradients against the
             oracle march at 256²; the warm step time
  preview    one `ProgressiveRenderer` pass at 1280×720 on a 4×4 spiral
  tests      the tests marked `gpu`

`--four` renders a 3840×2160 frame at 16 spp with `render_sharded` and
runs one 2048², spp-8 `train_step_sharded` on the four-card mesh, each
compared with the same work on one card.

The last line of standard output is one JSON object,
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`;
the line before names the card and its power limit as `nvidia-smi` does.
Without a GPU the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out")

# Image tolerances against the plain reference.  Triton and XLA contract
# FMAs differently, so an ulp can flip a bounce on a few lanes: each
# channel's mean within 1e-4 relative, at most 1e-3 of pixels off by more
# than 1e-3 absolute.
MEAN_RTOL = 1e-4
PIX_ATOL = 1e-3
PIX_FRAC = 1e-3
# One train step against the oracle march: loss relative, gradient
# relative L2.
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3

# The reference's default workload (GUI.cpp:201-208, Graphics.cpp:326-329)
SIDE = 1024
STEPS = 512
BOUNCES = 16
HEADLINE_SPP = 128
RGB_SPP = 32
PARITY_SPP = 8
TRAIN_SPP = 4
TRAIN_BOUNCES = 4      # inverse rendering fits short transport
GRAD_SIDE = 256        # loss/gradient check against the oracle march
PREVIEW = (1280, 720, 16)        # the reference window, 4x4 spiral, spp
FOUR_FRAME = (3840, 2160, 16)    # 4K over four cards, spp
FOUR_TRAIN = (2048, 8)           # BASELINE config 5 train step, spp


def log(tag: str, **fields) -> None:
    print(f"[{tag}] {json.dumps(fields, default=float)}", flush=True)


def check_image(tag, got, want, **extra):
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{tag}: shape {got.shape} vs {want.shape}, "
                             f"finite={bool(np.isfinite(got).all())}")
    mg, mw = got.mean(axis=(0, 1)), want.mean(axis=(0, 1))
    mean_rel = np.abs(mg - mw) / np.maximum(np.abs(mw), 1e-12)
    frac = float((np.abs(got - want) > PIX_ATOL).mean())
    log(tag, mean_rel=mean_rel.tolist(), frac_off=frac, **extra)
    if mean_rel.max() > MEAN_RTOL or frac > PIX_FRAC:
        raise AssertionError(f"{tag}: mean_rel {mean_rel.tolist()} "
                             f"frac_off {frac}")


def check_banks(tag, got, want):
    import numpy as np
    fields = {}
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.shape != b.shape:
            raise AssertionError(f"{tag}/{k}: {a.shape} vs {b.shape}")
        off = (np.abs(a - b) > PIX_ATOL) if k == "t" else (a != b)
        fields[k] = float(off.mean())
    log(tag, frac_off=fields)
    if max(fields.values()) > PIX_FRAC:
        raise AssertionError(f"{tag}: {fields}")


def timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def headline_cfg(**kw):
    from raymarchrenderer.render.config import RenderConfig
    base = dict(width=SIDE, height=SIDE, max_steps=STEPS,
                max_bounces=BOUNCES, relax_omega=2.0, normal_taps=4)
    base.update(kw)
    return RenderConfig(**base)


def corners_for(w, h):
    from raymarchrenderer.core.camera import Camera
    return Camera(aspect=w / h).corner_rays_flat()


def phase_headline():
    from raymarchrenderer.app import cli
    argv = ["render", "--spectral", "--width", str(SIDE), "--height",
            str(SIDE), "--spp", str(HEADLINE_SPP), "--max-steps", str(STEPS),
            "--max-bounces", str(BOUNCES), "--relax", "2.0",
            "--normal-taps", "4", "--chunk", str(HEADLINE_SPP),
            "--out", os.path.join(OUT, "smoke_headline.png")]
    walls = []
    for _ in range(2):  # cold (compiles) then warm
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError("headline render failed")
        walls.append(time.perf_counter() - t0)
    log("headline", wall_cold_s=walls[0], wall_warm_s=walls[1],
        compile_s=walls[0] - walls[1],
        mpix_spp_per_s=SIDE * SIDE * HEADLINE_SPP / walls[1] / 1e6)


def _rgb_scenes():
    from raymarchrenderer.scene import builtin
    cfg = headline_cfg()
    return [("rgb", builtin.sphere_on_floor(), cfg, False),
            ("nee", builtin.nee_demo(), cfg, True),
            ("dispersion", builtin.sphere_on_floor(),
             cfg.replace(separate_channels=True), False),
            ("env", builtin.env_demo(), cfg, False)]


def phase_rgb():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raymarchrenderer.kernels.march import render_fused
    corners = corners_for(SIDE, SIDE)
    spp = RGB_SPP
    for name, scene, cfg, nee in _rgb_scenes():
        params = scene.init_params()
        fn = jax.jit(lambda p, s, scene=scene, cfg=cfg, nee=nee:
                     render_fused(scene, p, cfg, corners, s, n_samples=spp,
                                  direct_light=nee))
        img, cold = timed(fn, params, jnp.uint32(0))
        _, warm = timed(fn, params, jnp.uint32(spp))
        if not np.isfinite(np.asarray(img)).all():
            raise AssertionError(f"rgb/{name}: non-finite image")
        log(f"rgb/{name}", spp=spp, cold_s=cold, warm_s=warm,
            mpix_spp_per_s=SIDE * SIDE * spp / warm / 1e6,
            mean=np.asarray(img).mean(axis=(0, 1)).tolist())


SCHEDULES = {"strict": dict(lazy_miss=False, regen_cadence=0),
             "production": {}}


def phase_parity():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raymarchrenderer.core.vecmath import Vec3
    from raymarchrenderer.kernels.march import (DEFAULT_MARCH_UNROLL,
                                                DEFAULT_REGEN_CADENCE,
                                                render_fused,
                                                render_fused_spectral)
    from raymarchrenderer.kernels.record import (trace_record_fused,
                                                 trace_record_fused_spectral)
    from raymarchrenderer.render import mega
    from raymarchrenderer.render.integrator import march, render_sample
    from raymarchrenderer.render.raygen import pixel_grid
    from raymarchrenderer.render.spectral_integrator import (
        render_sample_spectral, spectral_demo)
    from raymarchrenderer.scene import builtin

    spp = PARITY_SPP
    corners = corners_for(SIDE, SIDE)

    def oracle_mean(one, params):
        acc = None
        for s in range(spp):
            x = np.asarray(one(params, jnp.uint32(s)), np.float64)
            acc = x if acc is None else acc + x
        return (acc / spp).astype(np.float32)

    with jax.default_matmul_precision("highest"):
        for name, scene, cfg, nee in _rgb_scenes():
            params = scene.init_params()
            one = jax.jit(lambda p, s, scene=scene, cfg=cfg, nee=nee:
                          render_sample(scene, p, cfg, corners, s,
                                        direct_light=nee).stack(-1))
            want, t_oracle = timed(lambda p: oracle_mean(one, p), params)
            for sched, kw in SCHEDULES.items():
                got = render_fused(scene, params, cfg, corners,
                                   jnp.uint32(0), n_samples=spp,
                                   direct_light=nee, **kw)
                check_image(f"parity/{name}/{sched}", got, want,
                            oracle_s=t_oracle)

        scene, params, mats = spectral_demo()
        cfg = headline_cfg()
        one = jax.jit(lambda p, s: render_sample_spectral(
            scene, p, mats, cfg, corners, s).stack(-1))
        want = oracle_mean(one, params)
        for sched, kw in SCHEDULES.items():
            got = render_fused_spectral(scene, params, mats, cfg, corners,
                                        jnp.uint32(0), n_samples=spp, **kw)
            check_image(f"parity/spectral/{sched}", got, want)

        # recorders: bounce 0 against the oracle march of the primary
        # rays, every bank against the plain-jnp recorder (same schedule,
        # whole frame in XLA)
        cfg = headline_cfg(max_bounces=TRAIN_BOUNCES, relax_omega=1.9)
        px, py = pixel_grid(SIDE, SIDE)
        ones = Vec3.full((SIDE, SIDE), 1.0, 1.0, 1.0)
        for name, scene, nee in (("record", builtin.sphere_on_floor(), False),
                                 ("record-nee", builtin.nee_demo(), True)):
            params = scene.init_params()
            for sched, lazy in (("strict", False), ("production", not nee)):
                got = trace_record_fused(scene, params, cfg, corners, (0, 0),
                                         (SIDE, SIDE), jnp.uint32(0),
                                         direct_light=nee, n_samples=spp,
                                         lazy_miss=lazy)
                # lazy_miss tests misses at pass boundaries, so the plain
                # version runs the kernel's unroll and cadence with it
                sched_kw = (dict(march_unroll=DEFAULT_MARCH_UNROLL,
                                 regen_cadence=DEFAULT_REGEN_CADENCE)
                            if lazy else {})
                plain = jax.jit(lambda p, scene=scene, nee=nee, lazy=lazy,
                                kw=sched_kw: mega.trace_mega_paths(
                                    scene, p, cfg, corners, px, py,
                                    jnp.uint32(0), ones, n_samples=spp,
                                    shade_gate=0.0, direct_light=nee,
                                    record_banks=True, lazy_miss=lazy,
                                    **kw)[1])
                banks = plain(params)
                B = cfg.max_bounces
                want = {"t": banks[0], "mid": banks[1], "hit": banks[2]}
                want = {k: np.asarray(v).reshape(B, spp * SIDE, SIDE)
                        for k, v in want.items()}
                check_banks(f"parity/{name}/{sched}",
                            {k: got[k] for k in want}, want)
            # bounce 0, sample 0 against the oracle march itself
            rec = trace_record_fused(scene, params, cfg, corners, (0, 0),
                                     (SIDE, SIDE), jnp.uint32(0),
                                     direct_light=nee, lazy_miss=False)

            def oracle_march(p, scene=scene):
                from raymarchrenderer.core.rng import RNGStream
                from raymarchrenderer.render.raygen import (eye_vec,
                                                            primary_rays)
                rng = RNGStream(cfg.seed, px, py, jnp.uint32(0),
                                jnp.uint32(1 << 20))
                d = primary_rays(corners, px, py, SIDE, SIDE, rng)
                e = eye_vec(corners)
                eye = Vec3(*(jnp.broadcast_to(c, (SIDE, SIDE))
                             for c in (e.x, e.y, e.z)))
                t, mid, hit = march(scene, p, cfg, eye, d,
                                    jnp.ones((SIDE, SIDE)),
                                    jnp.ones((SIDE, SIDE), bool))
                return {"t": t, "mid": mid, "hit": hit.astype(jnp.int32)}
            want = jax.jit(oracle_march)(params)
            check_banks(f"parity/{name}/oracle-march",
                        {k: rec[k][0] for k in want}, want)

        scene, params, mats = spectral_demo()
        got = trace_record_fused_spectral(scene, params, mats, cfg, corners,
                                          (0, 0), (SIDE, SIDE),
                                          jnp.uint32(0), n_samples=spp,
                                          lazy_miss=False)
        banks = jax.jit(lambda p: mega.trace_mega_spectral(
            scene, p, mats, cfg, corners, px, py, jnp.uint32(0),
            n_samples=spp, record_banks=True)[1])(params)
        B = cfg.max_bounces
        want = {k: np.asarray(v).reshape(B, spp * SIDE, SIDE)
                for k, v in zip(("t", "mid", "hit"), banks)}
        check_banks("parity/record-spectral/strict", got, want)


def phase_train():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raymarchrenderer.app import cli
    from raymarchrenderer.kernels.march import render_fused
    from raymarchrenderer.parallel.sharding import (ShardConfig, make_mesh,
                                                    render_replicated_params,
                                                    train_step_sharded)
    from raymarchrenderer.render.integrator import render_patch_spp
    from raymarchrenderer.scene import builtin

    scene = builtin.sphere_on_floor()
    params = scene.init_params()
    cfg = headline_cfg(max_bounces=TRAIN_BOUNCES, relax_omega=1.9)
    corners = corners_for(SIDE, SIDE)
    # the target: the same scene with every parameter moved by 5%
    perturbed = jax.tree.map(lambda x: x * 1.05, params)
    target = render_fused(scene, perturbed, cfg, corners, jnp.uint32(10_000),
                          n_samples=16)
    tpath = os.path.join(OUT, "smoke_target.npy")
    np.save(tpath, np.asarray(target))
    argv = ["train", "--scene", "sphere_on_floor", "--target", tpath,
            "--width", str(SIDE), "--height", str(SIDE), "--spp",
            str(TRAIN_SPP), "--steps", "3", "--max-steps", str(STEPS),
            "--max-bounces", str(TRAIN_BOUNCES), "--relax", "1.9",
            "--normal-taps", "4", "--lr", "1e-3",
            "--out", os.path.join(OUT, "smoke_fit.npz")]
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("train failed")
    cli_s = time.perf_counter() - t0

    mesh = make_mesh(ShardConfig(1, 1))
    with mesh:
        p = render_replicated_params(scene, params, mesh)
        step = lambda p: train_step_sharded(  # noqa: E731
            scene, p, cfg, corners, jnp.asarray(target), mesh,
            spp=TRAIN_SPP, lr=1e-3, march_impl="recorded")
        (_, p), _ = timed(step, p)
        (loss, p), step_s = timed(step, p)
    if not np.isfinite(float(loss)):
        raise AssertionError("train: non-finite loss")

    # one step's loss and gradients against the oracle march
    g = GRAD_SIDE
    small = cfg.replace(width=g, height=g)
    c_small = corners_for(g, g)
    t_small = jax.image.resize(jnp.asarray(target), (g, g, 3), "linear")

    def loss_fn(p, impl):
        c = render_patch_spp(scene, p, small, c_small, (0, 0), (g, g),
                             jnp.uint32(0), TRAIN_SPP, differentiable=True,
                             march_impl=impl)
        return jnp.mean((c.stack(-1) / TRAIN_SPP - t_small) ** 2)

    with jax.default_matmul_precision("highest"):
        lr_, gr = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, "recorded")))(params)
        lo, go = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, "oracle")))(params)
    gr = np.concatenate([np.ravel(x) for x in jax.tree.leaves(gr)])
    go = np.concatenate([np.ravel(x) for x in jax.tree.leaves(go)])
    loss_rel = abs(float(lr_) - float(lo)) / abs(float(lo))
    grad_rel = float(np.linalg.norm(gr - go) / np.linalg.norm(go))
    log("train", cli_s=cli_s, step_s=step_s, loss=float(loss),
        mpix_spp_per_s=SIDE * SIDE * TRAIN_SPP / step_s / 1e6,
        loss_rel_vs_oracle=loss_rel, grad_rel_l2_vs_oracle=grad_rel)
    if loss_rel > LOSS_RTOL or grad_rel > GRAD_RTOL:
        raise AssertionError(f"train: loss_rel {loss_rel} "
                             f"grad_rel {grad_rel}")


def phase_preview():
    import numpy as np

    from raymarchrenderer.render.tiles import ProgressiveRenderer
    from raymarchrenderer.scene import builtin
    scene = builtin.sphere_on_floor()
    w, h, spp = PREVIEW
    cfg = headline_cfg(width=w, height=h, grid_width=4, grid_height=4,
                       spp=spp)
    walls = []
    for _ in range(2):  # cold (compiles) then warm
        pr = ProgressiveRenderer(scene, scene.init_params(), cfg,
                                 corners_for(w, h))
        t0 = time.perf_counter()
        img = np.asarray(pr.render_pass())
        walls.append(time.perf_counter() - t0)
    if pr.impl != "triton" or not np.isfinite(img).all():
        raise AssertionError(f"preview: impl {pr.impl}")
    log("preview", tiles=16, spp=spp, wall_cold_s=walls[0],
        wall_warm_s=walls[1])


def phase_tests():
    import pytest
    os.environ["RAYMARCH_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    log("tests", pytest_exit=int(rc))
    if rc != 0:
        raise AssertionError(f"gpu tests: pytest exit {rc}")


def phase_four():
    """The four-card path and the same work on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raymarchrenderer.kernels.march import render_fused_patch
    from raymarchrenderer.parallel.sharding import (ShardConfig, auto_shard,
                                                    make_mesh,
                                                    render_replicated_params,
                                                    render_sharded,
                                                    train_step_sharded)
    from raymarchrenderer.scene import builtin

    if len(jax.devices()) != 4:
        raise AssertionError(f"--four needs 4 cards, "
                             f"found {len(jax.devices())}")
    scene = builtin.sphere_on_floor()
    params = scene.init_params()
    w, h, spp = FOUR_FRAME
    cfg = headline_cfg(width=w, height=h)
    corners = corners_for(w, h)
    mesh = make_mesh(auto_shard())
    with mesh:
        fn = lambda: render_sharded(scene, params, cfg, corners,  # noqa
                                    mesh, spp=spp, impl="triton")
        _, cold = timed(fn)
        four, warm = timed(fn)
    one_card = jax.jit(lambda p: render_fused_patch(
        scene, p, cfg, corners, (0, 0), (h, w), jnp.uint32(0),
        n_samples=spp))
    dev0 = jax.devices()[0]
    one, one_s = timed(one_card, jax.device_put(params, dev0))
    _, one_s = timed(one_card, jax.device_put(params, dev0))
    check_image("four/render", four, one, mesh=dict(mesh.shape),
                four_cold_s=cold, four_warm_s=warm, one_card_s=one_s,
                bitwise=bool(np.array_equal(np.asarray(four),
                                            np.asarray(one))))

    side, spp = FOUR_TRAIN
    cfg = headline_cfg(width=side, height=side, max_bounces=TRAIN_BOUNCES,
                       relax_omega=1.9)
    corners = corners_for(side, side)
    target = jnp.zeros((side, side, 3), jnp.float32)
    flat = lambda t: np.concatenate(  # noqa: E731
        [np.ravel(np.asarray(x, np.float64)) for x in jax.tree.leaves(t)])
    results = {}
    for label, m in (("four", mesh),
                     ("one", make_mesh(ShardConfig(1, 1), [dev0]))):
        with m:
            p = render_replicated_params(scene, params, m)
            # at lr 1 the step's update is the all-reduced gradient itself
            step = lambda p, m=m: train_step_sharded(  # noqa: E731
                scene, p, cfg, corners, target, m, spp=spp, lr=1.0,
                march_impl="recorded")
            timed(step, p)
            (loss, new), dt = timed(step, p)
        results[label] = (float(loss), flat(params) - flat(new), dt)
    (l4, g4, s4), (l1, g1, s1) = results["four"], results["one"]
    loss_rel = abs(l4 - l1) / abs(l1)
    grad_rel = float(np.linalg.norm(g4 - g1) / np.linalg.norm(g1))
    log("four/train", loss_four=l4, loss_one=l1, loss_rel=loss_rel,
        grad_norm_one=float(np.linalg.norm(g1)), grad_rel_l2=grad_rel,
        step_four_s=s4, step_one_s=s1)
    if (loss_rel > LOSS_RTOL or grad_rel > GRAD_RTOL
            or not np.linalg.norm(g1) > 0):
        raise AssertionError(f"four/train: loss_rel {loss_rel} "
                             f"grad_rel {grad_rel}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
              "nothing to check", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from raymarchrenderer.utils.cache import enable_persistent_cache
    from raymarchrenderer.utils.profiling import gpu_name_power
    os.makedirs(OUT, exist_ok=True)
    log("device", platform=devices[0].platform,
        kind=devices[0].device_kind, count=len(devices),
        cache=enable_persistent_cache())
    t0 = time.perf_counter()
    phases = ([phase_four] if args.four else
              [phase_headline, phase_rgb, phase_parity, phase_train,
               phase_preview, phase_tests])
    for phase in phases:
        t = time.perf_counter()
        phase()
        log("phase", name=phase.__name__, s=time.perf_counter() - t)
    log("total", s=time.perf_counter() - t0)
    print(gpu_name_power(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
