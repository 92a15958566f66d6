"""The spectral (wavelength-transport) integrator — gen-3 `RayMarch3.glsl`.

Per-path state is a single wavelength (nm, 5 nm bins, 0 == "unset") plus a
scalar power (`RayMarch3.glsl:347-444`).  Materials are `ColorRange` band
filters × a power multiplier; emitters sample a wavelength from their band
on first contact and terminate the path; surfaces bounce with a uniform
hemisphere.  The sky is a 390–830 nm, power-0.015 emitter.  The final splat
is `wavelengthToColor(λ) · power` (`:447-522`).

Geometry reuses the RGB scene IR (`Scene.map`); spectral materials are a
flat SoA table aligned with the scene's material order.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

import numpy as np

from raymarchrenderer.core.rng import RNGStream
from raymarchrenderer.core.sampling import uniform_sphere_or_hemisphere
from raymarchrenderer.core.spectral import wavelength_to_rgb
from raymarchrenderer.core.vecmath import Vec3, vselect
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import get_normal, march
from raymarchrenderer.render.raygen import eye_vec, pixel_grid, primary_rays
from raymarchrenderer.scene.graph import Scene


class SpectralMaterials(NamedTuple):
    """SoA band-filter table, one row per scene material index.

    kind 0 = surface (band filter then hemisphere bounce, `mat_func_1/2`);
    kind 1 = emitter (band filter then terminate, `mat_func_0` + the
    unconditional break `RayMarch3.glsl:380`)."""
    min_wave: jax.Array   # f32[M]
    max_wave: jax.Array   # f32[M]
    power: jax.Array      # f32[M]
    kind: jax.Array       # i32[M]

    @staticmethod
    def table(rows) -> "SpectralMaterials":
        """rows: sequence of (min_wave, max_wave, power, kind)."""
        a = np.asarray(rows, np.float32).reshape(-1, 4)
        return SpectralMaterials(
            jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]),
            jnp.asarray(a[:, 3].astype(np.int32)))


def _lookup(mats: "SpectralMaterials", mid):
    """Per-lane band-table row select.

    A static unrolled where-chain over the (small, trace-time-known) material
    count instead of a dynamic gather: identical values, and inside the
    fused kernel the table rows are scalars in registers, so the spectral
    integrator runs there verbatim."""
    n = mats.min_wave.shape[0]
    shape = jnp.shape(mid)
    m_min = jnp.zeros(shape, jnp.float32)
    m_max = jnp.zeros(shape, jnp.float32)
    m_pow = jnp.zeros(shape, jnp.float32)
    m_kind = jnp.zeros(shape, jnp.int32)
    midc = jnp.clip(mid, 0, n - 1)
    for i in range(n):
        sel = midc == i
        m_min = jnp.where(sel, mats.min_wave[i], m_min)
        m_max = jnp.where(sel, mats.max_wave[i], m_max)
        m_pow = jnp.where(sel, mats.power[i], m_pow)
        m_kind = jnp.where(sel, mats.kind[i], m_kind)
    return m_min, m_max, m_pow, m_kind


def _apply_band(wl, power, u, min_w, max_w, mat_p):
    """One `mat_func_N` body (`RayMarch3.glsl:251-281`).

    unset (wl==0): sample wl = floor(u·(max−min)/5)·5 + min, power ×= p.
    set: outside [min, max] → absorbed (wl := 0, terminate);
         inside → power ×= p.  Returns (wl, power, absorbed)."""
    r = u * (max_w - min_w) / 5.0
    sampled = jnp.floor(r) * 5.0 + min_w
    unset = wl == 0.0
    outside = (wl < min_w) | (wl > max_w)
    new_wl = jnp.where(unset, sampled, jnp.where(outside, 0.0, wl))
    new_power = jnp.where(unset | ~outside, power * mat_p, power)
    absorbed = ~unset & outside
    return new_wl, new_power, absorbed


def _apply_band_soft(wl, power, u, min_w, max_w, mat_p, edge):
    """Differentiable band filter — the `train --spectral` path (round 4).

    Two reparameterizations of `_apply_band`'s non-differentiable pieces:

      * the unset-wavelength draw drops the 5 nm floor-binning:
        wl = min + u·(max−min) — pathwise gradients ∂wl/∂min = 1−u and
        ∂wl/∂max = u flow into the `wavelengthToColor` splat, so a band
        EDGE moves to explain the image's hue;
      * the binary absorb test becomes a smooth boxcar transmission
        T = σ((wl−min)/edge)·σ((max−wl)/edge): power ×= p·T and the path
        CONTINUES (T → 0 outside the band), so edges receive gradients
        from every interaction instead of a measure-zero indicator.

    As `edge → 0` both recover the hard filter (up to the 5 nm binning).
    Returns (wl, power, absorbed=all-False) — the soft path never
    terminates by absorption, it attenuates."""
    sampled = min_w + u * (max_w - min_w)
    unset = wl == 0.0
    t_soft = (jax.nn.sigmoid((wl - min_w) / edge)
              * jax.nn.sigmoid((max_w - wl) / edge))
    new_wl = jnp.where(unset, sampled, wl)
    new_power = power * mat_p * jnp.where(unset, 1.0, t_soft)
    return new_wl, new_power, jnp.zeros(jnp.shape(wl), bool)


def trace_spectral(scene: Scene, params, mats: SpectralMaterials,
                   cfg: RenderConfig, eye: Vec3, d0: Vec3, px, py, sample,
                   profile: bool = False,
                   differentiable: bool = False,
                   march_impl: str = "oracle",
                   soft_edge: float = 8.0,
                   recorded=None):
    """Gen-3 `trace` (`RayMarch3.glsl:347-444`), masked over the pixel batch.

    Returns (wavelength, power) per pixel.  `profile=True` (trace-time
    static) additionally returns per-lane work counters
    (segments marched, map evals in the march loops, hits shaded) — the
    measured numbers behind `bench.py`'s rays/s, using THIS loop, not a
    restatement.

    `differentiable=True` is the spectral inverse-rendering mode: marches
    run through the reparameterized implicit-function adjoint
    (`diff.march.march_diff`; march_impl "recorded" replays the marches
    banked by `kernels.record.trace_record_fused_spectral`) and
    band filters through `_apply_band_soft` (smooth boxcar of width
    `soft_edge` nm, continuous wavelength draw) — gradients reach the
    scene geometry AND the band-table rows (min/max/power)."""
    shape = jnp.shape(d0.x)
    sky_min, sky_max, sky_p = 390.0, 830.0, jnp.float32(cfg.sky_power)
    if differentiable:
        from raymarchrenderer.diff.march import (march_diff,
                                                 march_diff_recorded)
        if march_impl == "recorded":
            # spectral recorded mode: every march is a bank
            # lookup (kernels.record.trace_record_fused_spectral);
            # gradients attach via the shared implicit adjoint.  Geometry
            # is band-value independent (uniform-hemisphere directions,
            # soft filters never absorb), so one recording serves the
            # whole step's band/scene gradient.
            if recorded is None:
                raise ValueError(
                    "march_impl='recorded' needs recorded planes")
            march_fn = None
        else:
            march_fn = functools.partial(march_diff, scene, cfg, params)
        band = functools.partial(_apply_band_soft, edge=soft_edge)
    else:
        if march_impl == "recorded":
            raise ValueError("recorded mode is the differentiable "
                             "forward; render with the fused kernel")
        band = _apply_band

    def body(b, st, rec_b=None):
        if profile:
            o, d, wl, power, active_i, segs, msteps, hits = st
        else:
            o, d, wl, power, active_i = st
        active = active_i > 0  # int32 0/1 carry
        ones = jnp.ones(shape, jnp.float32)
        if profile:
            t, mid, hitm, steps = march(scene, params, cfg, o, d, ones,
                                        active, with_steps=True)
            segs = segs + active.astype(jnp.int32)
            msteps = msteps + steps
        elif differentiable:
            if rec_b is not None:
                t, mid, hitm = march_diff_recorded(
                    scene, cfg, params, o, d, active,
                    rec_b["t"], rec_b["mid"], rec_b["hit"])
            else:
                t, mid, hitm = march_fn(o, d, ones, active)
        else:
            t, mid, hitm = march(scene, params, cfg, o, d, ones, active)
        hitp = o + d * t
        normal = get_normal(scene, params, cfg, hitp)
        rng = RNGStream(cfg.seed, px, py, sample, b)

        m_min, m_max, m_pow, m_kind = _lookup(mats, mid)

        u = rng.next()
        hit_active = active & hitm
        miss_active = active & ~hitm
        if profile:
            hits = hits + hit_active.astype(jnp.int32)

        # surface / emitter band filter
        wl_h, pw_h, absorbed = band(wl, power, u, m_min, m_max, m_pow)
        # sky emitter on miss
        wl_s, pw_s, absorbed_s = band(wl, power, u, sky_min, sky_max, sky_p)

        new_wl = jnp.where(hit_active, wl_h, jnp.where(miss_active, wl_s, wl))
        new_power = jnp.where(hit_active, pw_h,
                              jnp.where(miss_active, pw_s, power))

        # terminate: emitter hit, absorption (hard mode — the soft filter
        # attenuates instead of absorbing), or any miss (sky terminates)
        terminate = (hit_active & ((m_kind == 1) | absorbed)) | miss_active
        new_active = active & hitm & ~terminate

        new_dir = uniform_sphere_or_hemisphere(rng.next(), rng.next(), normal)
        o2 = hitp + normal * cfg.surface_offset  # 0.002, RayMarch3.glsl:405
        o = vselect(new_active, o2, o)
        d = vselect(new_active, new_dir, d)
        out = (o, d, new_wl, new_power, new_active.astype(jnp.int32))
        if profile:
            return out + (segs, msteps, hits)
        return out

    init = (eye, d0, jnp.zeros(shape, jnp.float32),
            jnp.ones(shape, jnp.float32), jnp.ones(shape, jnp.int32))
    if profile:
        zi = jnp.zeros(shape, jnp.int32)
        init = init + (zi, zi, zi)
    # peel bounce 0 (see trace_rgb)
    if recorded is not None:
        # replay as a lax.scan over bounces with the bank slices as
        # scanned inputs — a static unroll makes the XLA graph (and its
        # reverse-mode double) O(max_bounces), minutes-class compiles at
        # dryrun shapes (same lesson as trace_rgb's recorded replay)
        st0 = body(0, init, {k: recorded[k][0] for k in
                             ("t", "mid", "hit")})
        if cfg.max_bounces > 1:
            rest = {k: recorded[k][1:] for k in ("t", "mid", "hit")}
            bs = jnp.arange(1, cfg.max_bounces, dtype=jnp.int32)

            def scan_body(st, xs):
                b, rec_b = xs
                return body(b, st, rec_b), None

            out, _ = lax.scan(scan_body, st0, (bs, rest))
        else:
            out = st0
    else:
        st0 = body(0, init)
        out = lax.fori_loop(1, cfg.max_bounces, body, st0)
    wl, power = out[2], out[3]
    # paths that exhaust maxBounces keep their (possibly unset) wavelength —
    # wl==0 maps to black, exactly like the GLSL uint 0 → wavelengthToColor(0)
    if profile:
        return wl, power, out[5], out[6], out[7]
    return wl, power


def render_sample_spectral(scene: Scene, params, mats: SpectralMaterials,
                           cfg: RenderConfig, corners, sample) -> Vec3:
    """One full-frame spectral sample → linear RGB via `wavelengthToColor`."""
    px, py = pixel_grid(cfg.width, cfg.height)
    rng = RNGStream(cfg.seed, px, py, sample, jnp.uint32(1 << 20))
    d = primary_rays(corners, px, py, cfg.width, cfg.height, rng)
    shape = (cfg.height, cfg.width)
    e = eye_vec(corners)
    eye = Vec3(jnp.broadcast_to(e.x, shape), jnp.broadcast_to(e.y, shape),
               jnp.broadcast_to(e.z, shape))
    wl, power = trace_spectral(scene, params, mats, cfg, eye, d, px, py,
                               sample)
    return wavelength_to_rgb(wl) * power


@functools.partial(jax.jit, static_argnums=(0, 3))
def _spectral_step(scene, params, mats, cfg, corners, accum_n, sample):
    from raymarchrenderer.render.integrator import accumulate
    accum, n = accum_n
    color = render_sample_spectral(scene, params, mats, cfg, corners, sample)
    return accumulate(accum, color, n), n + 1.0


def render_spectral(scene: Scene, params, mats: SpectralMaterials,
                    cfg: RenderConfig, corners, spp: int = None,
                    accum=None, n0: float = 0.0):
    spp = cfg.spp if spp is None else spp
    if accum is None:
        accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    state = (accum, jnp.float32(n0))
    for s in range(int(n0), int(n0) + spp):
        state = _spectral_step(scene, params, mats, cfg, corners, state,
                               jnp.uint32(s))
    return state[0], float(state[1])


def render_patch_spp_spectral(scene: Scene, params, mats, cfg: RenderConfig,
                              corners, origin_xy, patch_shape, sample0,
                              n_samples: int,
                              differentiable: bool = False,
                              march_impl: str = "oracle",
                              soft_edge: float = 8.0,
                              interpret: bool = False) -> Vec3:
    """All `n_samples` spectral samples of a patch in ONE batched trace —
    the gen-3 twin of `render.integrator.render_patch_spp` (sample axis
    folded into rows; returns the per-pixel RGB-splat SUM; the caller
    normalizes).  With `differentiable=True` this is the spectral
    training forward (see `trace_spectral`)."""
    ph, pw = patch_shape
    S = int(n_samples)
    ox, oy = origin_xy[0], origin_xy[1]
    row = jnp.arange(ph, dtype=jnp.int32)[None, :, None]
    col = jnp.arange(pw, dtype=jnp.int32)[None, None, :]
    sid = (jnp.asarray(sample0, jnp.uint32)
           + jnp.arange(S, dtype=jnp.uint32)[:, None, None])
    shape = (S * ph, pw)
    py = jnp.broadcast_to(row + oy, (S, ph, pw)).reshape(shape)
    px = jnp.broadcast_to(col + ox, (S, ph, pw)).reshape(shape)
    sample = jnp.broadcast_to(sid, (S, ph, pw)).reshape(shape)
    rng = RNGStream(cfg.seed, px, py, sample, jnp.uint32(1 << 20))
    d = primary_rays(corners, px, py, cfg.width, cfg.height, rng)
    e = eye_vec(corners)
    eye = Vec3(jnp.broadcast_to(e.x, shape), jnp.broadcast_to(e.y, shape),
               jnp.broadcast_to(e.z, shape))
    recorded = None
    if march_impl == "recorded":
        # ONE Pallas launch records every (sample, bounce) march with
        # in-loop sample regeneration; the trace below is a pure XLA
        # band/splat replay over the recorded geometry
        from raymarchrenderer.kernels.record import (
            trace_record_fused_spectral)
        recorded = trace_record_fused_spectral(
            scene, params, mats, cfg, corners, origin_xy, patch_shape,
            sample0, n_samples=S, interpret=interpret)
    wl, power = trace_spectral(scene, params, mats, cfg, eye, d, px, py,
                               sample, differentiable=differentiable,
                               march_impl=march_impl, soft_edge=soft_edge,
                               recorded=recorded)
    c = wavelength_to_rgb(wl) * power
    return Vec3(c.x.reshape(S, ph, pw).sum(0),
                c.y.reshape(S, ph, pw).sum(0),
                c.z.reshape(S, ph, pw).sum(0))


def default_band_table(scene: Scene) -> SpectralMaterials:
    """A neutral gen-3-style band table for an arbitrary RGB scene:
    emissive materials become 380–780 nm power-8 emitter bands
    (`mat_func_0`, `RayMarch3.glsl:251-262`), everything else a
    380–780 nm ×0.8 filter (`mat_func_1`).  Scenes can override this
    per-material with `spectral` blocks in the `.scene` JSON — use
    `band_table` to honor them."""
    rows = [(380.0, 780.0, 8.0, 1) if scene.is_emissive(i)
            else (380.0, 780.0, 0.8, 0)
            for i in range(len(scene.materials))]
    return SpectralMaterials.table(rows)


def band_table(scene: Scene) -> SpectralMaterials:
    """The scene's gen-3 band table: scene-authored `spectral` blocks
    (`Scene.spectral_rows`, parsed from `.scene` JSON or set via
    `SceneBuilder.spectral_band`) when present, else the neutral default."""
    if scene.spectral_rows:
        return SpectralMaterials.table(scene.spectral_rows)
    return default_band_table(scene)


def spectral_demo():
    """The gen-3 hardcoded scene (`RayMarch3.glsl:132-143,251-345`):
    380–780 nm power-8 sphere emitter, 380–780 nm ×0.8 floor,
    490–590 nm ×0.8 sphere.  The bands ride the scene itself
    (`sphere_on_floor`'s spectral blocks; file twin
    `data/scenes/spectral.scene`).  Returns (scene, params, mats)."""
    from raymarchrenderer.scene.builtin import sphere_on_floor
    scene = sphere_on_floor()  # same geometry, material order 0/1/2
    return scene, scene.init_params(), band_table(scene)
