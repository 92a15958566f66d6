"""Headline benchmark: Mpix·spp/s (and rays/s) at 1024×1024 on one card.

Runs the flagship progressive path trace (sphere-on-floor scene — the gen-3
hardcoded scene of `RayMarch3.glsl:132-143` — at the reference's default
workload: 1024×1024, maxSteps=512, maxBounces=16, `GUI.cpp:201-208` /
`Graphics.cpp:326-329`) in ONE process on the default device and prints
ONE JSON line naming that device (kind, count, `nvidia-smi` name and power
limit).  It benches the fused GPU kernels; where the route chooser
(`kernels/route.py`) finds no GPU it refuses, unless BENCH_IMPL=oracle
asks for the plain-jnp oracle explicitly.

Env knobs: BENCH_SIZE (default 1024), BENCH_SPP (default 128 — the
reference GUI default, all samples in ONE megakernel launch with in-loop
path regeneration), BENCH_MODE=spectral|rgb (default spectral — the
reference's ACTIVE kernel is the gen-3 spectral tracer, and the spectral
megakernel's smaller lane state also makes it the fastest path; rgb runs
the gen-1/gen-2-style RGB-throughput transport over the same geometry),
BENCH_IMPL=auto|oracle (default auto = the GPU kernels), BENCH_RELAX (default
2.0 — safeguarded over-relaxed sphere tracing; set 0 for the reference's
classic stepMultiply=0.5 march), BENCH_NORMAL_TAPS (default 4 —
tetrahedron stencil, the measured optimum on this cheap scene map; 0 =
exact ∇map via one vjp sweep, 6 = reference-parity central differences).  The accelerated march/normals
produce the same hit set and O(ε)-identical images (tests/test_relax.py);
the workload — scene, resolution, spp, bounce/step budgets — is the
reference default either way.
"""
from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp


def main():
    size = int(os.environ.get("BENCH_SIZE", "1024"))
    spp = int(os.environ.get("BENCH_SPP", "128"))
    impl = os.environ.get("BENCH_IMPL", "auto")

    from raymarchrenderer.kernels.route import ORACLE, TRITON, kernel_route
    from raymarchrenderer.utils.cache import enable_persistent_cache
    from raymarchrenderer.utils.profiling import device_report
    if impl not in ("auto", TRITON, ORACLE):
        raise SystemExit(f"BENCH_IMPL={impl!r}: use auto, triton or oracle")
    route = kernel_route()
    if impl != ORACLE and route != TRITON:
        raise SystemExit("no GPU: bench.py times the fused kernels; pass "
                         "BENCH_IMPL=oracle to time the plain-jnp oracle")
    use_pallas = impl != ORACLE
    enable_persistent_cache()

    from raymarchrenderer.core.camera import Camera
    from raymarchrenderer.render.config import RenderConfig
    from raymarchrenderer.scene.builtin import sphere_on_floor

    relax = float(os.environ.get("BENCH_RELAX", "2.0"))
    taps = int(os.environ.get("BENCH_NORMAL_TAPS", "4"))
    mode = os.environ.get("BENCH_MODE", "spectral")
    # the workload knobs below only exist on the RGB transport — fail
    # LOUDLY rather than silently bench the spectral headline instead
    # (a `BENCH_ENV=1 python bench.py` that quietly prints the 254 line
    # would be a false datapoint)
    if mode != "rgb":
        for knob in ("BENCH_DIRECT", "BENCH_ENV", "BENCH_DISPERSION"):
            if os.environ.get(knob, "0") == "1":
                raise SystemExit(
                    f"{knob}=1 requires BENCH_MODE=rgb (it selects an RGB-"
                    f"transport workload); BENCH_MODE={mode!r} would "
                    f"silently ignore it.")
    # BENCH_DISPERSION=1: gen-1 separateChannels (`RayMarch.glsl:580-598`)
    # folded into the megakernel regen loop — rgb mode only
    dispersion = (os.environ.get("BENCH_DISPERSION", "0") == "1"
                  and mode == "rgb")
    # BENCH_ENV=1: same geometry under an equirect env map (the
    # `veranda_1k.hdr` path, `Graphics.cpp:287`) — exercises the deferred
    # -sky kernel with K-banked miss events + bilinear lookups.
    # The reference's HDR asset is stripped from the mount, so a synthetic
    # 512x1024 gradient sky stands in (identical lookup work).
    use_env = os.environ.get("BENCH_ENV", "0") == "1" and mode == "rgb"
    # BENCH_DIRECT=1: light-sampling workload (NEE + soft shadows via
    # light marching, `RayMarch2.glsl:480-501` / BASELINE config 2) on the
    # same geometry + one sphere light — shadow marches run as extra
    # in-loop segments of the megakernel.
    use_nee = os.environ.get("BENCH_DIRECT", "0") == "1" and mode == "rgb"
    from raymarchrenderer.scene import builtin
    if use_nee:
        scene = builtin.nee_demo()
    elif use_env:
        # BENCH_ENV_FILTER=nearest: 1-tap GL_NEAREST lookups.
        # BENCH_ENV_GATHER=mxu (default): the deferred-sky composite's
        # lookups are bilinear gathers from the solid-angle-prefiltered
        # 32x64 mip; =exact gathers the full-res texture (the
        # reference-parity mode).
        scene = builtin.env_demo(
            env_filter=os.environ.get("BENCH_ENV_FILTER", "linear"),
            env_gather=os.environ.get("BENCH_ENV_GATHER", "mxu"))
    else:
        scene = sphere_on_floor()
    params = scene.init_params()
    cfg = RenderConfig(width=size, height=size, relax_omega=relax,
                       normal_taps=taps, separate_channels=dispersion)
    corners = Camera(aspect=size / size).corner_rays_flat()

    # schedule knobs (lazy boundary miss test + cheap retire cadence —
    # render.mega docstrings); defaults are the kernel's,
    # BENCH_LAZY_MISS=0 / BENCH_REGEN_CADENCE=0 restore the strict
    # schedule
    from raymarchrenderer.kernels.march import (DEFAULT_LAZY_MISS,
                                                    DEFAULT_REGEN_CADENCE)
    lazy = os.environ.get("BENCH_LAZY_MISS",
                          "1" if DEFAULT_LAZY_MISS else "0") == "1"
    cadence = int(os.environ.get("BENCH_REGEN_CADENCE",
                                 str(DEFAULT_REGEN_CADENCE)))
    if use_pallas and mode == "spectral":
        from raymarchrenderer.kernels.march import render_fused_spectral
        from raymarchrenderer.render.spectral_integrator import (
            spectral_demo)
        scene, params, mats = spectral_demo()
        step = jax.jit(lambda p, c, s: render_fused_spectral(
            scene, p, mats, cfg, c, s, n_samples=spp,
            lazy_miss=lazy, regen_cadence=cadence))
        impl = "pallas-mega-spectral"
    elif use_pallas:
        from raymarchrenderer.kernels.march import render_fused
        # one launch, in-kernel spp loop: samples accumulate in
        # registers, HBM sees one write per pixel
        step = jax.jit(lambda p, c, s: render_fused(
            scene, p, cfg, c, s, n_samples=spp, direct_light=use_nee,
            lazy_miss=lazy, regen_cadence=cadence))
        impl = ("pallas-mega-nee" if use_nee
                else f"pallas-env-mega-deferred-{scene.env_gather}"
                if use_env
                else "pallas-mega-dispersion" if dispersion
                else "pallas-mega")
    else:
        from raymarchrenderer.render.integrator import render_sample
        step = jax.jit(lambda p, c, s: render_sample(
            scene, p, cfg, c, s).stack(-1))
        impl = "oracle"

    # warmup / compile
    out = step(params, corners, jnp.uint32(0))
    jax.block_until_ready(out)

    if impl == "oracle":
        t0 = time.perf_counter()
        acc = jnp.zeros_like(out)
        for s in range(1, spp + 1):
            acc = acc + step(params, corners, jnp.uint32(s))
        jax.block_until_ready(acc)
        dt = time.perf_counter() - t0
    else:
        times = []
        for s in (1, 2):
            t0 = time.perf_counter()
            jax.block_until_ready(step(params, corners, jnp.uint32(s * spp)))
            times.append(time.perf_counter() - t0)
        dt = min(times)

    mpix_spp_s = size * size * spp / dt / 1e6
    dev = device_report()
    result = {
        "metric": "Mpix*spp/s @ %dx%d (impl=%s, device=%s)" % (
            size, size, impl, dev["kind"]),
        "value": mpix_spp_s,
        "unit": "Mpix*spp/s",
        "device": dev,
        "wall_s": dt,
        "spp": spp,
        "relax_omega": relax,
        "normal_taps": taps,
        "dispersion": dispersion,
    }

    # measured work profile (spectral transport): rays/s = samples/s x
    # measured path segments; map-evals/s from the march-loop counters
    # (utils.metrics.spectral_path_profile runs the production trace with
    # its opt-in per-lane counters — nothing is estimated offline).
    if mode == "spectral" and os.environ.get("BENCH_PROFILE", "1") == "1":
        from raymarchrenderer.render.spectral_integrator import band_table
        from raymarchrenderer.utils.metrics import spectral_path_profile
        mats = band_table(scene)
        prof = spectral_path_profile(scene, params, mats, cfg, corners,
                                     jnp.uint32(1), n_samples=4)
        samples_s = mpix_spp_s * 1e6
        result.update({
            "rays_per_s": samples_s * prof["segments_per_sample"],
            "map_evals_per_s": samples_s * prof["map_evals_per_sample"],
            **prof,
        })
        # measured divergence bound: fraction of megakernel march-step
        # lane slots that actually marched (the rest were parked between
        # shade-pass cadences or exhausted)
        from raymarchrenderer.utils.metrics import mega_occupancy_profile
        result.update(mega_occupancy_profile(
            scene, params, mats, cfg, corners, jnp.uint32(1),
            n_samples=min(spp, 128), tiles=4))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
