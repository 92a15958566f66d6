"""CLI frontend: render / save / bench / repl.

Supersedes the reference's two frontends:
  * the SFGUI panel (`GUI.cpp:181-321`: Render button, samples, image W/H,
    grid W/H, scene path) → flags on the `render` subcommand;
  * the stdin REPL (`CLI.cpp:190-219`: load_scene, samples, grid_width,
    grid_height, render, save) → the `repl` subcommand speaks the same
    verbs.

`render` is restartable: --checkpoint persists (accum, n, config) after
every chunk and --resume continues from it (the reference's
Escape-preserves-the-buffer semantics, `Program.cpp:188-194`).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _build_scene(args):
    from raymarchrenderer.scene import builtin, load_scene
    env = None
    if getattr(args, "env_map", None):
        from raymarchrenderer.io import load_env_map
        env = load_env_map(args.env_map)
    if args.scene and os.path.exists(args.scene):
        return load_scene(args.scene, env_image=env)
    builtins_ = {
        "sphere_on_floor": builtin.sphere_on_floor,
        "single_sphere": builtin.single_sphere,
        "csg": builtin.csg_demo,
        "cornell": builtin.cornell,
        "glass": builtin.glass_demo,
        "volume": builtin.volume_demo,
    }
    if args.scene in builtins_:
        return builtins_[args.scene]()
    raise SystemExit(f"scene not found: {args.scene!r} "
                     f"(builtins: {', '.join(builtins_)})")


def _camera(args):
    from raymarchrenderer.core.camera import Camera
    cam = Camera(aspect=args.width / args.height)
    if args.eye:
        cam.eye = tuple(args.eye)
    if args.look_at:
        cam.look_at(tuple(args.look_at))
    if args.fov:
        cam.fov = args.fov
    return cam


def _config(args):
    from raymarchrenderer.render.config import RenderConfig
    return RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        max_steps=args.max_steps, max_bounces=args.max_bounces,
        max_dist=args.max_dist, seed=args.seed,
        relax_omega=getattr(args, "relax", 0.0) or 0.0,
        normal_taps=getattr(args, "normal_taps", 6))


def _add_render_flags(p):
    p.add_argument("--scene", default="sphere_on_floor",
                   help="scene file path or builtin name")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--spp", type=int, default=128)
    p.add_argument("--max-steps", type=int, default=512)
    p.add_argument("--max-bounces", type=int, default=16)
    p.add_argument("--max-dist", type=float, default=1000.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--look-at", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--env-map", default=None,
                   help="equirect environment map (.hdr/.npy/.png) — the "
                        "reference's veranda_1k.hdr slot (Graphics.cpp:287)")
    p.add_argument("--direct-light", action="store_true",
                   help="next-event estimation / soft shadows")
    p.add_argument("--spectral", action="store_true",
                   help="gen-3 wavelength transport (RayMarch3.glsl); "
                        "builtin sphere_on_floor uses the exact hardcoded "
                        "gen-3 band table, other scenes a neutral one")
    p.add_argument("--relax", type=float, default=0.0,
                   help="over-relaxed sphere tracing omega (e.g. 1.9); "
                        "0 = reference-parity stepMultiply=0.5 march")
    p.add_argument("--normal-taps", type=int, choices=(0, 4, 6), default=6,
                   help="SDF normal estimator: 6 central-diff (parity) or "
                        "4 tetrahedron (faster)")
    p.add_argument("--impl", choices=("auto", "triton", "oracle"),
                   default="auto",
                   help="fused Pallas kernel (GPU) or pure-JAX oracle; "
                        "auto picks by device (kernels/route.py)")
    p.add_argument("--out", default=None,
                   help="output image (.png/.bmp/.npy); default "
                        "output/<timestamp>.png")
    p.add_argument("--checkpoint", default=None,
                   help="write (accum, n, config) here after every chunk")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--chunk", type=int, default=8,
                   help="samples per kernel launch / checkpoint interval")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    p.add_argument("--metrics", default=None,
                   help="append structured JSONL metrics to this file")
    p.add_argument("--profile", default=None,
                   help="capture a jax.profiler trace into this logdir")


def _pick_impl(args):
    if args.impl != "auto":
        return args.impl
    # every scene and frame size runs fused on the GPU: env-map scenes on
    # the deferred-sky kernel, and render_fused_patch pads-and-crops any
    # size to its block (the reference's 1280x720 window included)
    from raymarchrenderer.kernels.route import kernel_route
    return kernel_route()


def cmd_render(args) -> int:
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raymarchrenderer.io import (load_checkpoint, save_checkpoint,
                                         save_image, timestamp_name)
    from raymarchrenderer.render.integrator import render

    from raymarchrenderer.io.checkpoint import scene_digest

    scene = _build_scene(args)
    params = scene.init_params()
    cfg = _config(args)
    corners = _camera(args).corner_rays_flat()
    digest = scene_digest(scene, params) if args.checkpoint else None

    accum, n0 = None, 0.0
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        # refuses (SceneMismatchError) when the checkpoint was produced by
        # a different scene — resuming would blend two scenes' images
        st = load_checkpoint(args.checkpoint, expect_scene_digest=digest)
        # geometry/seed come from the checkpoint (the accumulator's shape
        # and RNG stream are bound to them) but the spp TARGET is the
        # caller's: `--resume --spp 256` extends a finished 128-spp render
        # instead of silently rendering zero new samples
        accum, n0, cfg = jnp.asarray(st.accum), st.n, st.cfg.replace(
            spp=cfg.spp)
        print(f"resuming at {n0:.0f} spp from {args.checkpoint}")

    impl = _pick_impl(args)
    spp_left = max(0, cfg.spp - int(n0))
    print(f"rendering {cfg.width}x{cfg.height} @ {cfg.spp} spp "
          f"({impl}, {jax.devices()[0].platform})")
    metrics = None
    if args.metrics:
        from raymarchrenderer.utils import MetricsLogger
        metrics = MetricsLogger(args.metrics)
        metrics.log("render_start", width=cfg.width, height=cfg.height,
                    spp=cfg.spp, impl=impl,
                    platform=jax.devices()[0].platform)
    profile_cm = None
    if args.profile:
        from raymarchrenderer.utils import trace_to
        profile_cm = trace_to(args.profile)
        profile_cm.__enter__()
    t0 = time.perf_counter()
    n = n0

    if args.spectral:
        from raymarchrenderer.render.spectral_integrator import (
            band_table, render_spectral)
        # scene-authored `spectral` blocks (e.g. spectral.scene /
        # sphere_on_floor carry the exact gen-3 bands) or neutral default
        mats = band_table(scene)

        def spectral_cb(s, state):
            jax.block_until_ready(state[0])
            if args.checkpoint:
                save_checkpoint(args.checkpoint, np.asarray(state[0]),
                                float(state[1]), cfg, scene_digest=digest)
            el = time.perf_counter() - t0
            print(f"  {s}/{cfg.spp} spp "
                  f"({(s - n0) / max(el, 1e-9):.2f} spp/s)", flush=True)

        if impl == "triton":
            from raymarchrenderer.kernels.march import (
                render_progressive_fused_spectral)
            img, n = render_progressive_fused_spectral(
                scene, params, mats, cfg, corners, spp=spp_left,
                samples_per_launch=args.chunk, accum=accum, n0=n0,
                callback=spectral_cb)
        else:
            img, n = render_spectral(scene, params, mats, cfg, corners,
                                     spp=spp_left, accum=accum, n0=n0)
    elif impl == "triton":
        from raymarchrenderer.kernels.march import render_progressive_fused
        done = int(n0)
        img = accum if accum is not None else jnp.zeros(
            (cfg.height, cfg.width, 3), jnp.float32)
        while done < cfg.spp:
            k = min(args.chunk, cfg.spp - done)
            img, n = render_progressive_fused(
                scene, params, cfg, corners, spp=k,
                samples_per_launch=k, direct_light=args.direct_light,
                accum=img, n0=float(done))
            done += k
            jax.block_until_ready(img)
            if args.checkpoint:
                save_checkpoint(args.checkpoint, np.asarray(img), n, cfg,
                                scene_digest=digest)
            el = time.perf_counter() - t0
            print(f"  {done}/{cfg.spp} spp  "
                  f"({done / max(el, 1e-9):.2f} spp/s)", flush=True)
    else:
        def cb(s, state):
            if args.checkpoint and (s + 1) % args.chunk == 0:
                save_checkpoint(args.checkpoint, np.asarray(state[0]),
                                float(state[1]), cfg, scene_digest=digest)
            if (s + 1) % args.chunk == 0:
                jax.block_until_ready(state[0])
                el = time.perf_counter() - t0
                print(f"  {s + 1 - int(n0)}/{spp_left} spp "
                      f"({(s + 1 - n0) / max(el, 1e-9):.2f} spp/s)",
                      flush=True)

        img, n = render(scene, params, cfg, corners, spp=spp_left,
                        direct_light=args.direct_light, accum=accum, n0=n0,
                        callback=cb)

    # the render is done when the device is: dispatch returns long before
    img = jax.block_until_ready(img)
    dt = time.perf_counter() - t0
    if profile_cm is not None:
        profile_cm.__exit__(None, None, None)
    mpix_spp = cfg.width * cfg.height * (n - n0) / 1e6
    t1 = time.perf_counter()
    host = np.asarray(img)
    fetch_s = time.perf_counter() - t1
    out = args.out or os.path.join("output", timestamp_name("png"))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    t1 = time.perf_counter()
    save_image(out, host)
    save_s = time.perf_counter() - t1
    print(f"done: {n:.0f} spp in {dt:.3f}s "
          f"({mpix_spp / max(dt, 1e-9):.2f} Mpix*spp/s); "
          f"fetch {fetch_s:.3f}s, save {save_s:.3f}s")
    if metrics is not None:
        metrics.log("render_done", spp=float(n), wall_s=round(dt, 3),
                    mpix_spp_per_s=round(mpix_spp / max(dt, 1e-9), 4),
                    fetch_s=round(fetch_s, 4), save_s=round(save_s, 4))
        metrics.close()
    if args.checkpoint:
        save_checkpoint(args.checkpoint, host, n, cfg, scene_digest=digest)
    print(f"saved {out}")
    return 0


def cmd_train(args) -> int:
    """Inverse rendering: fit the scene's differentiable parameters to a
    target image (BASELINE config 4/5 as a product verb).

    Runs `parallel.sharding.train_step_sharded` over the available device
    mesh — on the GPU the recording kernel's forward (one launch records
    every march), reparameterized adjoint, psum grad all-reduce, SGD — and
    writes the fitted parameter pytree (npz) plus a render with the
    recovered parameters."""
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raymarchrenderer.io import save_image
    from raymarchrenderer.io.image import (_srgb_to_linear_np, load_bmp,
                                               load_exr, load_png)
    from raymarchrenderer.parallel.sharding import (
        auto_shard, make_mesh, render_replicated_params, render_sharded,
        train_step_sharded)

    scene = _build_scene(args)
    params = scene.init_params()
    cfg = _config(args)
    corners = _camera(args).corner_rays_flat()

    ext = os.path.splitext(args.target)[1].lower()
    if ext == ".npy":
        target = np.load(args.target).astype(np.float32)
    elif ext == ".exr":
        target = load_exr(args.target)
    elif ext == ".png":
        target = load_png(args.target)
    elif ext == ".bmp":
        target = _srgb_to_linear_np(
            load_bmp(args.target).astype(np.float32) / 255.0)
    else:
        raise SystemExit(f"unsupported target format: {args.target!r}")
    if target.shape != (cfg.height, cfg.width, 3):
        raise SystemExit(
            f"target is {target.shape}, render is "
            f"({cfg.height}, {cfg.width}, 3) — pass matching -W/-H")
    target = jnp.asarray(target)

    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    # the kernel route records the forward in one launch per chip
    # ("recorded"); the oracle route marches in plain XLA
    impl = _pick_impl(args)
    march_impl = "recorded" if impl == "triton" else "oracle"

    if args.spectral:
        # spectral inverse rendering (round 4): the band filter is
        # reparameterized — smooth-boxcar transmission + continuous
        # wavelength draw (`spectral_integrator._apply_band_soft`) — so
        # gradients reach the band-table rows (min/max/power) and the
        # scene geometry; see train_step_spectral_sharded.
        from raymarchrenderer.parallel.sharding import (
            render_sharded_spectral, train_step_spectral_sharded)
        from raymarchrenderer.render.spectral_integrator import (
            band_table)
        mats = band_table(scene)
        mesh = make_mesh(auto_shard())
        with mesh:
            params = render_replicated_params(scene, params, mesh)
            for k in range(args.steps):
                loss, params, mats = train_step_spectral_sharded(
                    scene, params, mats, cfg, corners, target, mesh,
                    spp=args.spp, lr=args.lr, march_impl=march_impl,
                    sample0=k * args.spp)
                if k % max(1, args.steps // 10) == 0 or k == args.steps - 1:
                    print(f"step {k:4d} loss {float(loss):.6f}", flush=True)
            img = render_sharded_spectral(scene, params, mats, cfg,
                                          corners, mesh, spp=args.spp,
                                          impl=impl)
        jax.block_until_ready(img)
        out = args.out or "output/fitted_params.npz"
        if not out.endswith(".npz"):
            out += ".npz"
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        leaves, _ = jax.tree.flatten(jax.device_get(params))
        np.savez(out,
                 band_min_wave=np.asarray(mats.min_wave),
                 band_max_wave=np.asarray(mats.max_wave),
                 band_power=np.asarray(mats.power),
                 **{f"leaf{i}": np.asarray(l)
                    for i, l in enumerate(leaves)})
        png = os.path.splitext(out)[0] + ".png"
        save_image(png, np.asarray(img))
        print(f"saved {out} and {png} (final loss {float(loss):.6f})")
        return 0

    mesh = make_mesh(auto_shard())
    with mesh:
        params = render_replicated_params(scene, params, mesh)
        for k in range(args.steps):
            loss, params = train_step_sharded(
                scene, params, cfg, corners, target, mesh, spp=args.spp,
                lr=args.lr, direct_light=args.direct_light,
                march_impl=march_impl)
            if k % max(1, args.steps // 10) == 0 or k == args.steps - 1:
                print(f"step {k:4d} loss {float(loss):.6f}", flush=True)
        img = render_sharded(scene, params, cfg, corners, mesh,
                             spp=args.spp, direct_light=args.direct_light,
                             impl=impl)
    jax.block_until_ready(img)

    out = args.out or "output/fitted_params.npz"
    if not out.endswith(".npz"):
        out += ".npz"  # np.savez appends it anyway; keep the report honest
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    leaves, _ = jax.tree.flatten(jax.device_get(params))
    np.savez(out, **{f"leaf{i}": np.asarray(l)
                     for i, l in enumerate(leaves)})
    png = os.path.splitext(out)[0] + ".png"
    save_image(png, np.asarray(img))
    print(f"saved {out} and {png} (final loss {float(loss):.6f})")
    return 0


def cmd_bench(args) -> int:
    os.environ.setdefault("BENCH_SIZE", str(args.size))
    os.environ.setdefault("BENCH_SPP", str(args.spp))
    os.environ.setdefault("BENCH_IMPL", args.impl)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import bench
    bench.main()
    return 0


def cmd_parity(args) -> int:
    """Run the gated golden-image parity check (exit nonzero on gate
    failure) — the committed-artifact workflow as a product verb.

    Works from a WHEEL install too (round 5): the gated goldens ship
    downscaled as package data (`raymarchrenderer/data/parity/`) and
    the packaged re-authored default scene stands in for the reference
    checkout; with the reference mount present, the full-resolution BMPs
    and the reference's own scene file are used instead."""
    from raymarchrenderer.utils.parity import run_parity
    return run_parity()


def cmd_info(args) -> int:
    scene = _build_scene(args)
    import jax
    params = scene.init_params()
    n_params = sum(x.size for x in jax.tree.leaves(params))
    print(json.dumps({
        "materials": len(scene.materials),
        "objects": len(scene.objects),
        "lights": scene.n_lights,
        "env_map": scene.has_env_map,
        "differentiable_params": int(n_params),
    }, indent=2))
    return 0


def cmd_repl(args) -> int:
    """The reference REPL verbs (`CLI.cpp:95-219`), line-oriented."""
    state = {"scene": "sphere_on_floor", "spp": 16, "width": 256,
             "height": 256, "grid_w": 4, "grid_h": 4, "img": None}
    print("raymarch repl — verbs: load_scene <path>, samples <n>, "
          "image_width <n>, image_height <n>, grid_width <n>, "
          "grid_height <n>, render, save [path], quit")
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        verb, rest = parts[0], parts[1:]
        try:
            if verb == "quit":
                break
            elif verb == "load_scene":
                state["scene"] = rest[0]
                print(f"scene = {rest[0]}")
            elif verb == "samples":
                state["spp"] = int(rest[0])
            elif verb in ("image_width", "image_height", "grid_width",
                          "grid_height"):
                key = {"image_width": "width", "image_height": "height",
                       "grid_width": "grid_w", "grid_height": "grid_h"}[verb]
                state[key] = int(rest[0])
            elif verb == "render":
                # the grid verbs DRIVE the schedule, like the reference's
                # gridW/gridH feed the spiral walk (`CLI.cpp:95-126`,
                # `Program.cpp:107-119`): every tile gets all samples,
                # tiles in spiral order from the center
                import time as _time

                import numpy as _np

                from raymarchrenderer.io import save_image
                from raymarchrenderer.render.tiles import (
                    ProgressiveRenderer)
                ns = argparse.Namespace(
                    scene=state["scene"], env_map=None, seed=0,
                    width=state["width"], height=state["height"],
                    spp=state["spp"], max_steps=512, max_bounces=16,
                    max_dist=1000.0, eye=None, look_at=None, fov=None)
                scene = _build_scene(ns)
                cfg = _config(ns).replace(grid_width=state["grid_w"],
                                          grid_height=state["grid_h"])
                pr = ProgressiveRenderer(scene, scene.init_params(), cfg,
                                         _camera(ns).corner_rays_flat())
                t0 = _time.perf_counter()
                n_tiles = state["grid_w"] * state["grid_h"]
                done = [0]

                def _tile_cb(tx, ty, accum):
                    done[0] += 1
                    print(f"  tile ({tx},{ty}) {done[0]}/{n_tiles}",
                          flush=True)

                img = pr.render_pass(spp=state["spp"], callback=_tile_cb)
                dt = _time.perf_counter() - t0
                print(f"render time: {dt:.2f}s")  # Program.cpp:296 parity
                save_image("/tmp/_repl_render.png", _np.asarray(img))
                state["img"] = "/tmp/_repl_render.png"
            elif verb == "save":
                if state["img"] is None:
                    print("nothing rendered yet")
                else:
                    import shutil
                    from raymarchrenderer.io import timestamp_name
                    dst = rest[0] if rest else os.path.join(
                        "output", timestamp_name("png"))
                    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
                    shutil.copy(state["img"], dst)
                    print(f"saved {dst}")
            else:
                print(f"unknown verb: {verb}")
        except (IndexError, ValueError) as e:
            print(f"bad arguments for {verb}: {e}")
    return 0


def cmd_viewer(args) -> int:
    from raymarchrenderer.app.viewer import serve
    serve(port=args.port, host=args.host)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="raymarchrenderer",
        description="differentiable sphere-tracing path tracer")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the persistent XLA compilation cache")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to an image")
    _add_render_flags(pr)
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="run the headline benchmark")
    pb.add_argument("--size", type=int, default=1024)
    pb.add_argument("--spp", type=int, default=8)
    pb.add_argument("--impl", choices=("auto", "triton", "oracle"),
                    default="auto")
    pb.set_defaults(fn=cmd_bench)

    pt = sub.add_parser(
        "train", help="inverse-render: fit scene parameters to a target "
                      "image over the device mesh")
    _add_render_flags(pt)
    pt.add_argument("--target", required=True,
                    help="target image (.png/.bmp/.exr sRGB-or-linear, "
                         ".npy linear float32), size must match -W/-H")
    pt.add_argument("--steps", type=int, default=100)
    pt.add_argument("--lr", type=float, default=1e-2)
    pt.set_defaults(fn=cmd_train)

    pi = sub.add_parser("info", help="describe a scene")
    pi.add_argument("--scene", default="sphere_on_floor")
    pi.set_defaults(fn=cmd_info)

    pp = sub.add_parser("repl", help="reference-CLI-compatible REPL")
    pp.set_defaults(fn=cmd_repl)

    pg = sub.add_parser(
        "parity", help="gated parity check against the reference's 2015 "
                       "golden BMPs (tools/reference_parity.py)")
    pg.set_defaults(fn=cmd_parity)

    pv = sub.add_parser("viewer",
                        help="interactive browser viewer (the GUI frontend)")
    pv.add_argument("--port", type=int, default=8000)
    pv.add_argument("--host", default="127.0.0.1")
    pv.set_defaults(fn=cmd_viewer)

    args = p.parse_args(argv)
    if not args.no_cache:
        # before any jax.jit: repeat renders at a (shape, schedule) skip
        # the compile (utils/cache.py; the reference instead recompiles
        # its shader every reload, Graphics.cpp:741-742)
        from raymarchrenderer.utils.cache import enable_persistent_cache
        enable_persistent_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
