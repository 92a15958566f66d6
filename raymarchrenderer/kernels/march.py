"""Fused Pallas kernels on the GPU (Triton route): raygen + march + shade
+ accumulate in one launch.

The replacement for the reference's GLSL compute dispatch
(`Graphics::Render` → `glDispatchCompute` → `RayMarch3.glsl:524-555`):
one `pallas_call` renders the whole frame, gridded over (bh, bw) pixel
blocks — the reference's 16×16 work groups (`RayMarch3.glsl:14`) with one
lane per pixel.  Inside each program:

  * pixel coords from `program_id` + `broadcasted_iota` (the
    `gl_GlobalInvocationID` analogue),
  * the SAME pure-jnp megakernel schedule, integrator and counter-based
    RNG as the plain version (`render.mega.trace_mega_paths` /
    `trace_mega_spectral`) traced over the block — one source of truth,
    bitwise-matching random streams,
  * per-block early-out: each program runs its own masked `while_loop`
    with every lane's path state in registers, so a block whose lanes
    finish stops — which a whole-frame XLA while_loop cannot do (it steps
    until the LAST pixel of the frame converges and round-trips every
    carry through HBM each iteration),
  * an in-kernel spp loop (`n_samples`) with in-loop path regeneration:
    HBM sees ONE write per pixel per launch.

Scene parameters, band tables, camera corners and launch scalars arrive as
scalar rows (`kernels.ship`) and are rebuilt inside the kernel, so ANY
data-driven scene graph compiles into the kernel with zero string codegen
— the trace-time equivalent of the reference's `//#…INSERT` GLSL splicing
(`Graphics.cpp:64-113`).

Env-map scenes use a *deferred sky*: the kernel stores each path's (at
most one) miss event — throughput and packed equirect (u, v) — into bank
outputs, and the lookup (`RayMarch.glsl:78-113` semantics) composites
outside in plain XLA: color + miss_thr · sky(u, v).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raymarchrenderer.core.vecmath import Vec3
from raymarchrenderer.kernels.ship import next_pow2, pack, unpack
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.mega import trace_mega_paths
from raymarchrenderer.scene.graph import Scene

# Launch shape: (bh, bw) pixels per program (powers of two) and warps per
# program — 256 pixels on 256 threads, one lane per pixel.  Swept on an
# H100 over blocks (8,16)…(16,32) × warps {2,4,8} × the schedule below on
# the spectral headline, RGB-NEE and the recorder (CHANGES.md, PR 1).
DEFAULT_BH = 8
DEFAULT_BW = 32
NUM_WARPS = 8
# Megakernel schedule (render.mega): shade pass once per `march_unroll`
# masked march steps, unconditionally (gate 0); `lazy_miss` moves the
# per-step miss test to pass boundaries; `regen_cadence` adds a cheap
# retire pass every k steps.  The cadence must divide the unroll, and the
# unroll should divide max_steps (misalignment reintroduces a step-budget
# overshoot at rare grazing lanes).  Unroll 64 costs 3x the compile time
# and runs slower; 32/16 was the fastest on all three workloads.
DEFAULT_SHADE_GATE = 0.0
DEFAULT_MARCH_UNROLL = 32
DEFAULT_LAZY_MISS = True
DEFAULT_REGEN_CADENCE = 16


def launch_block(block, shape):
    """Clamp a power-of-two block to the (power-of-two rounded) plane and
    return (bh, bw, padded h, padded w).  The plane is padded UP to a
    block multiple (never shrink the block to a divisor: a prime width
    would launch 1-wide programs); padded lanes render real rays at
    out-of-frame coords and are cropped — each pixel is independent and
    the RNG is keyed on absolute coords, so kept pixels are bitwise
    invariant to the padding."""
    bh, bw = block
    if bh != next_pow2(bh) or bw != next_pow2(bw):
        raise ValueError(f"block {block} must be powers of two")
    h, w = shape
    bh, bw = min(bh, next_pow2(h)), min(bw, next_pow2(w))
    return bh, bw, -(-h // bh) * bh, -(-w // bw) * bw


def pallas_launch(kernel, rows, grid, out_specs, out_shape, interpret):
    """`pallas_call` on the Triton route with the packed scalar rows as
    whole-array inputs."""
    in_specs = [pl.BlockSpec(r.shape, lambda i, j: (0, 0)) for r in rows]
    return pl.pallas_call(
        kernel, grid=grid, in_specs=in_specs, out_specs=out_specs,
        out_shape=out_shape, backend="triton", interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
    )(*rows)


class BankRefs:
    """A block's output refs for the record / deferred-sky banks, as
    `render.mega` writes them: slot `s` of bank `i` is the (bh, bw) plane
    `refs[i][s]`, and a record is one masked scatter store of each lane's
    value at its own (slot, y, x)."""

    def __init__(self, refs):
        self.refs = refs

    def fill(self, i, slot, value):
        self.refs[i][slot] = value

    def store(self, i, slot, value, mask):
        shape = jnp.shape(slot)
        yy = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        xx = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        plgpu.store(self.refs[i].at[jnp.where(mask, slot, 0), yy, xx],
                    value, mask=mask)


def _no_env_image(params):
    """The env image never enters a kernel (the composite gathers it in
    XLA): swap it for an empty leaf so nothing is shipped."""
    if "env" not in params or "image" not in params["env"]:
        return params
    params = dict(params)
    params["env"] = dict(params["env"])
    params["env"]["image"] = np.zeros((0, 0, 3), np.float32)
    return params


def _launch_rows(tree, sample, origin_xy):
    """Pack `tree` (params / corners / ...) with the launch scalars."""
    return pack(dict(tree, sample=jnp.asarray(sample, jnp.uint32),
                     oy=jnp.asarray(origin_xy[1], jnp.int32),
                     ox=jnp.asarray(origin_xy[0], jnp.int32)))


def _block_pixels(t, bh, bw):
    """(px, py) int32 planes of this program's block from the unpacked
    launch scalars."""
    i = pl.program_id(0)
    j = pl.program_id(1)
    py = t["oy"] + i * bh + jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 0)
    px = t["ox"] + j * bw + jax.lax.broadcasted_iota(jnp.int32, (bh, bw), 1)
    return px, py


def _corner_tuple(corners):
    return tuple(corners[k] for k in range(5))


@functools.partial(
    jax.jit,
    static_argnames=("scene", "cfg", "patch_shape", "n_samples",
                     "direct_light", "block", "interpret", "shade_gate",
                     "march_unroll", "normalize", "lazy_miss",
                     "regen_cadence"))
def render_fused_patch(scene: Scene, params, cfg: RenderConfig, corners,
                       origin_xy, patch_shape, sample0,
                       n_samples: int = 1, direct_light: bool = False,
                       block=(DEFAULT_BH, DEFAULT_BW),
                       interpret: bool = False,
                       shade_gate: float = DEFAULT_SHADE_GATE,
                       march_unroll: int = DEFAULT_MARCH_UNROLL,
                       normalize: bool = True,
                       lazy_miss: bool = DEFAULT_LAZY_MISS,
                       regen_cadence: int = DEFAULT_REGEN_CADENCE):
    """Mean of `n_samples` samples of a (ph, pw) pixel patch at dynamic
    origin `origin_xy` — the fused-kernel twin of
    `render.integrator.render_patch` (unit of tile sharding).  Returns
    (ph, pw, 3) float32 linear.  RGB, NEE, dispersion and env-map
    scenes all run the megakernel schedule.

    `normalize=False` returns the raw per-pixel SUM over samples instead of
    the mean — callers that merge shards (`parallel.sharding`) divide once
    at the end, keeping the sharded result bitwise-equal to the unsharded
    oracle (mean→sum→mean would round twice).

    `interpret=True` runs the Pallas interpreter (the CPU test path)."""
    if interpret:
        # unroll/cadence are pure scheduling knobs (bitwise invariant); the
        # interpreter just pays its trace blow-up, so keep tests fast.
        # lazy_miss is kept as passed (its divergence class is what the
        # interpreter tests pin down).
        march_unroll = 1
        regen_cadence = 0
    defer_sky = scene.has_env_map
    ph, pw = patch_shape
    bh, bw, php, pwp = launch_block(block, patch_shape)
    grid = (php // bh, pwp // bw)
    unit = 3 if cfg.separate_channels else 1
    shipped = {"params": _no_env_image(params) if defer_sky else params,
               "corners": jnp.stack([jnp.asarray(c, jnp.float32)
                                     for c in corners])}

    def launch(sample, k_paths):
        """One kernel launch over `k_paths` paths per pixel (== samples,
        or 3× samples under dispersion)."""
        rows, layout = _launch_rows(shipped, sample, origin_xy)

        def kernel(f_ref, i_ref, out_r, out_g, out_b, *bank_refs):
            t = unpack(layout, f_ref, i_ref)
            px, py = _block_pixels(t, bh, bw)
            s0 = t["sample"]
            channels = Vec3.full((bh, bw), 1.0, 1.0, 1.0)
            n_samp = k_paths // unit
            if defer_sky and cfg.separate_channels:
                # the host counts chunks in PATH units; the lane counter
                # wants sample units
                s0 = s0 // jnp.uint32(3)
            c = trace_mega_paths(
                scene, t["params"], cfg, _corner_tuple(t["corners"]), px,
                py, s0, channels, n_samples=n_samp, shade_gate=shade_gate,
                march_unroll=march_unroll,
                dispersion=cfg.separate_channels,
                direct_light=direct_light, defer_sky=defer_sky,
                lazy_miss=lazy_miss, regen_cadence=regen_cadence,
                bank_refs=BankRefs(bank_refs) if defer_sky else None)
            if defer_sky:
                c = c[0]
            # deferred-sky chunks emit RAW sums: the host divides ONCE
            # after compositing every chunk
            inv = 1.0 / float(n_samp) if normalize and not defer_sky \
                else 1.0
            out_r[...] = c.x * inv
            out_g[...] = c.y * inv
            out_b[...] = c.z * inv

        plane_spec = pl.BlockSpec((bh, bw), lambda i, j: (i, j))
        plane = jax.ShapeDtypeStruct((php, pwp), jnp.float32)
        out_specs = [plane_spec] * 3
        out_shape = [plane] * 3
        if defer_sky:
            bank_spec = pl.BlockSpec((k_paths, bh, bw),
                                     lambda i, j: (0, i, j))
            out_specs += [bank_spec] * 4
            out_shape += [jax.ShapeDtypeStruct((k_paths, php, pwp), dt)
                          for dt in (jnp.float32,) * 3 + (jnp.int32,)]
        return pallas_launch(kernel, rows, grid, tuple(out_specs),
                             tuple(out_shape), interpret)

    if not defer_sky:
        r, g, b = launch(sample0, n_samples * unit)
        return jnp.stack([r, g, b], axis=-1)[:ph, :pw]

    def one_chunk(sample, k_paths):
        """One K-deep launch + the XLA sky composite: the banked miss
        throughputs scatter the equirect lookups back onto the hit
        accumulation.  Dead slots carry thr=0."""
        r, g, b, tr, tg, tb, uvp = (a[..., :ph, :pw]
                                    for a in launch(sample, k_paths))
        # +0.5: reconstruct at the quantization-bin center
        u = (((uvp >> 16) & 0xffff).astype(jnp.float32) + 0.5) / 65536.0
        v = ((uvp & 0xffff).astype(jnp.float32) + 0.5) / 65536.0
        sky = scene.sky_uv(params, u, v)                  # (K, ph, pw)
        return jnp.stack([r + (tr * sky.x).sum(0),
                          g + (tg * sky.y).sum(0),
                          b + (tb * sky.z).sum(0)], axis=-1)

    # miss-event bank depth per launch: deep enough to keep the
    # megakernel's cross-sample regeneration, small enough that the
    # (K, ph, pw) banks stay bounded in HBM.  Chunks are WHOLE samples:
    # bulk chunks at depth K_BANK paths plus one tail launch at its own
    # smaller depth for a non-multiple spp.
    n_paths = n_samples * unit
    K_BANK = min(32 // unit, n_samples) * unit
    s0 = jnp.asarray(sample0, jnp.uint32) * jnp.uint32(unit)
    n_full = n_paths // K_BANK
    rem = n_paths - n_full * K_BANK
    if n_full == 1:
        total = one_chunk(s0, K_BANK)
    else:
        def chunk_body(c, acc):
            return acc + one_chunk(
                s0 + jnp.uint32(c) * jnp.uint32(K_BANK), K_BANK)
        total = jax.lax.fori_loop(0, n_full, chunk_body,
                                  jnp.zeros((ph, pw, 3), jnp.float32))
    if rem:
        total = total + one_chunk(s0 + jnp.uint32(n_full * K_BANK), rem)
    return total / float(n_samples) if normalize else total


def render_fused(scene: Scene, params, cfg: RenderConfig, corners,
                 sample0, n_samples: int = 1, direct_light: bool = False,
                 block=(DEFAULT_BH, DEFAULT_BW), interpret: bool = False,
                 shade_gate: float = DEFAULT_SHADE_GATE,
                 march_unroll: int = DEFAULT_MARCH_UNROLL,
                 lazy_miss: bool = DEFAULT_LAZY_MISS,
                 regen_cadence: int = DEFAULT_REGEN_CADENCE):
    """Full-frame fused render (patch at origin (0,0))."""
    return render_fused_patch(
        scene, params, cfg, corners, (0, 0), (cfg.height, cfg.width),
        sample0, n_samples=n_samples, direct_light=direct_light,
        block=block, interpret=interpret, shade_gate=shade_gate,
        march_unroll=march_unroll, lazy_miss=lazy_miss,
        regen_cadence=regen_cadence)


def render_sample_fused(scene: Scene, params, cfg: RenderConfig, corners,
                        sample, direct_light: bool = False,
                        interpret: bool = False):
    """One full-frame sample — drop-in for `render.integrator.render_sample`
    (returns the stacked (H, W, 3) array)."""
    return render_fused(scene, params, cfg, corners, sample, n_samples=1,
                        direct_light=direct_light, interpret=interpret)


def render_progressive_fused(scene: Scene, params, cfg: RenderConfig,
                             corners, spp: int = None,
                             samples_per_launch: int = 8,
                             direct_light: bool = False,
                             accum=None, n0: float = 0.0,
                             interpret: bool = False):
    """Progressive render driven by the fused kernel: `spp` total samples in
    chunks of `samples_per_launch` (each chunk is ONE kernel launch whose
    samples accumulate on-chip).  Resumable like `render.integrator.render`.
    Returns (image (H, W, 3), n_samples)."""
    spp = cfg.spp if spp is None else spp
    if accum is None:
        accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    n = float(n0)
    s = int(n0)
    while s < int(n0) + spp:
        k = min(samples_per_launch, int(n0) + spp - s)
        chunk = render_fused(scene, params, cfg, corners, jnp.uint32(s),
                             n_samples=k, direct_light=direct_light,
                             interpret=interpret)
        # running mean: new_mean = (accum*n + chunk*k) / (n+k)
        accum = (accum * n + chunk * k) / (n + k)
        n += k
        s += k
    return accum, n


def render_progressive_fused_spectral(scene: Scene, params, mats,
                                      cfg: RenderConfig, corners,
                                      spp: int = None,
                                      samples_per_launch: int = 8,
                                      accum=None, n0: float = 0.0,
                                      interpret: bool = False,
                                      callback=None):
    """Progressive gen-3 spectral render via the fused megakernel —
    resumable like `render_progressive_fused`.  Returns (image, n)."""
    spp = cfg.spp if spp is None else spp
    if accum is None:
        accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    n = float(n0)
    s = int(n0)
    while s < int(n0) + spp:
        k = min(samples_per_launch, int(n0) + spp - s)
        chunk = render_fused_spectral(scene, params, mats, cfg, corners,
                                      jnp.uint32(s), n_samples=k,
                                      interpret=interpret)
        accum = (accum * n + chunk * k) / (n + k)
        n += k
        s += k
        if callback is not None:
            callback(s, (accum, n))
    return accum, n


@functools.partial(
    jax.jit,
    static_argnames=("scene", "cfg", "n_samples", "block", "interpret",
                     "shade_gate", "march_unroll", "patch_shape",
                     "normalize", "lazy_miss", "regen_cadence"))
def render_fused_spectral(scene: Scene, params, mats, cfg: RenderConfig,
                          corners, sample0, n_samples: int = 1,
                          block=(DEFAULT_BH, DEFAULT_BW),
                          interpret: bool = False,
                          shade_gate: float = DEFAULT_SHADE_GATE,
                          march_unroll: int = DEFAULT_MARCH_UNROLL,
                          origin_xy=(0, 0), patch_shape=None,
                          normalize: bool = True,
                          lazy_miss: bool = DEFAULT_LAZY_MISS,
                          regen_cadence: int = DEFAULT_REGEN_CADENCE):
    """Fused gen-3 spectral render (`RayMarch3.glsl` wavelength transport)
    as ONE Pallas launch of the spectral megakernel
    (`render.mega.trace_mega_spectral`: per-lane bounces + in-loop sample
    regeneration).  Returns the (H, W, 3) mean (or the raw sum with
    `normalize=False` — the exact-merge contract of `render_fused_patch`).
    `origin_xy` + `patch_shape` render a sub-rectangle at a dynamic origin
    (the tile-sharding unit; RNG on absolute coords keeps any
    decomposition bitwise).  Parity vs `render_sample_spectral` tested via
    `interpret=True`."""
    from raymarchrenderer.render.mega import trace_mega_spectral

    if interpret:
        # pure scheduling knobs; keep interpreter traces fast (cadence
        # parity is covered by direct trace_mega_spectral tests)
        march_unroll = 1
        regen_cadence = 0
    ph, pw = patch_shape if patch_shape is not None else (cfg.height,
                                                          cfg.width)
    bh, bw, php, pwp = launch_block(block, (ph, pw))
    rows, layout = _launch_rows(
        {"params": _no_env_image(params), "mats": mats,
         "corners": jnp.stack([jnp.asarray(c, jnp.float32)
                               for c in corners])},
        sample0, origin_xy)
    inv = 1.0 / float(n_samples) if normalize else 1.0

    def kernel(f_ref, i_ref, out_r, out_g, out_b):
        t = unpack(layout, f_ref, i_ref)
        px, py = _block_pixels(t, bh, bw)
        c = trace_mega_spectral(scene, t["params"], t["mats"], cfg,
                                _corner_tuple(t["corners"]), px, py,
                                t["sample"], n_samples=n_samples,
                                shade_gate=shade_gate,
                                march_unroll=march_unroll,
                                lazy_miss=lazy_miss,
                                regen_cadence=regen_cadence)
        out_r[...] = c.x * inv
        out_g[...] = c.y * inv
        out_b[...] = c.z * inv

    spec = pl.BlockSpec((bh, bw), lambda i, j: (i, j))
    plane = jax.ShapeDtypeStruct((php, pwp), jnp.float32)
    r, g, b = pallas_launch(kernel, rows, (php // bh, pwp // bw),
                            (spec,) * 3, (plane,) * 3, interpret)
    return jnp.stack([r, g, b], axis=-1)[:ph, :pw]
