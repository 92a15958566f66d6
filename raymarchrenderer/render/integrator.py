"""The pure-JAX oracle integrator — gen-1 (`RayMarch.glsl`) semantics.

This is the semantics oracle everything else is tested against (SURVEY.md §7
step 2): a jitted, CPU-runnable, fully-vectorized re-statement of the GLSL
per-pixel pipeline:

    main → trace → march loop (≤maxSteps map evals × ≤maxBounces bounces)
    RayMarch.glsl:567-613, :483-565, :233-257

Design notes:
  * The march is a `lax.while_loop` over the *whole pixel batch* with a
    per-pixel done mask — the batch exits when every lane has hit or missed,
    so it steps until the slowest lane of the frame is done; the Pallas
    megakernels exit per block instead (`kernels/march.py`).
  * The bounce loop is `lax.fori_loop`; the shading code (trace-time-composed
    scene graphs) is traced ONCE, with the bounce index folded into the
    counter-based RNG stream.
  * Optional next-event estimation ("direct light") reproduces the gen-2
    direct-light + shadow-march pattern (`RayMarch2.glsl:480-501`) against
    the scene's `lights` (soft shadows via light marching — BASELINE
    config 2).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from raymarchrenderer.core.rng import RNGStream
from raymarchrenderer.core.sampling import uniform_sphere
from raymarchrenderer.core.vecmath import Vec3, vselect
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.raygen import eye_vec, pixel_grid, primary_rays
from raymarchrenderer.scene.graph import Scene
from raymarchrenderer.scene.nodes import ShadeCtx

_PI = 3.14159265358979323846


def march(scene: Scene, params, cfg: RenderConfig, o: Vec3, d: Vec3,
          dist_mult, active, with_steps: bool = False, t_max=None):
    """Sphere trace: returns (t, mat_index, hit_mask).

    Parity with `march` (`RayMarch.glsl:233-257`): per step evaluate
    map(o + t d) * dist_mult; hit when < hit_eps (returning the *pre-step*
    t); miss when t >= max_dist; advance t += dist * step_multiply; give up
    after max_steps → miss.

    `with_steps=True` additionally returns the per-lane count of map evals
    spent (a 4th output) — the measured-work hook for `utils.metrics` /
    `bench.py`; the flag is trace-time static so the production path
    compiles without the extra carry.

    `t_max` (scalar or per-lane f32, default `cfg.max_dist`) caps the
    marched distance: lanes reaching it report a miss with t == t_max.
    Shadow rays pass the light distance so the visibility march stops AT
    the light instead of burning the full `max_steps` budget."""
    if cfg.relax_omega > 1.0:
        return _march_relaxed(scene, params, cfg, o, d, dist_mult, active,
                              with_steps, t_max)
    tmax = cfg.max_dist if t_max is None else t_max
    shape = jnp.shape(o.x)
    t0 = jnp.zeros(shape, jnp.float32)
    mid0 = jnp.full(shape, -1, jnp.int32)
    # loop-carried masks are int32 0/1, the megakernels' lane-state
    # encoding
    hit0 = jnp.zeros(shape, jnp.int32)
    done0 = 1 - active.astype(jnp.int32)
    steps0 = jnp.zeros(shape, jnp.int32)

    def cond(s):
        _, _, _, done, step = s[:5]
        return (step < cfg.max_steps) & (jnp.min(done) < 1)

    def body(s):
        if with_steps:
            t, mid, hitm, done, step, steps = s
        else:
            t, mid, hitm, done, step = s
        p = o + d * t
        dist, m = scene.map(params, p, cfg.max_dist)
        dist = dist * dist_mult
        live = done < 1
        is_hit = (dist < cfg.hit_eps) & live
        is_miss = (t >= tmax) & live & ~is_hit
        mid = jnp.where(is_hit, m, mid)
        hitm = hitm | is_hit.astype(jnp.int32)
        done = done | is_hit.astype(jnp.int32) | is_miss.astype(jnp.int32)
        t = jnp.where(done > 0, t, t + dist * cfg.step_multiply)
        if with_steps:
            return t, mid, hitm, done, step + 1, steps + live.astype(jnp.int32)
        return t, mid, hitm, done, step + 1

    init = (t0, mid0, hit0, done0, jnp.int32(0))
    if with_steps:
        out = lax.while_loop(cond, body, init + (steps0,))
    else:
        out = lax.while_loop(cond, body, init)
    t, mid, hitm = out[0], out[1], out[2]
    hit_b = hitm > 0
    t = jnp.where(hit_b, t, tmax)
    mid = jnp.where(hit_b, mid, -1)
    if with_steps:
        return t, mid, hit_b, out[5]
    return t, mid, hit_b


def _march_relaxed(scene: Scene, params, cfg: RenderConfig, o: Vec3, d: Vec3,
                   dist_mult, active, with_steps: bool = False, t_max=None):
    """Safeguarded over-relaxed sphere trace (`cfg.relax_omega` > 1).

    Same contract as `march`: returns (t, mat_index, hit_mask) with hits in
    the same surface-ε band.  Accepts a relaxed step (t += dist·ω) only when
    the new unbounding sphere overlaps the previous one
    (radius_i + radius_{i-1} ≥ step taken); on failure it backs the lane off
    by (ω-1)·step and finishes the segment at ω=1 — so no surface a classic
    march would find is ever skipped (for a distance-underestimating map)."""
    shape = jnp.shape(o.x)
    t0 = jnp.zeros(shape, jnp.float32)
    mid0 = jnp.full(shape, -1, jnp.int32)
    hit0 = jnp.zeros(shape, jnp.int32)
    done0 = 1 - active.astype(jnp.int32)
    om0 = jnp.full(shape, cfg.relax_omega, jnp.float32)
    zero = jnp.zeros(shape, jnp.float32)
    tmax = cfg.max_dist if t_max is None else t_max

    steps0 = jnp.zeros(shape, jnp.int32)

    def cond(s):
        done, step = s[3], s[4]
        return (step < cfg.max_steps) & (jnp.min(done) < 1)

    def body(s):
        if with_steps:
            t, mid, hitm, done, step, omega, prev_r, step_len, steps = s
        else:
            t, mid, hitm, done, step, omega, prev_r, step_len = s
        p = o + d * t
        dist, m = scene.map(params, p, cfg.max_dist)
        dist = dist * dist_mult
        live = done < 1
        fail = live & (omega > 1.0) & (dist + prev_r < step_len)
        is_hit = live & ~fail & (dist < cfg.hit_eps)
        is_miss = live & ~fail & ~is_hit & (t >= tmax)
        mid = jnp.where(is_hit, m, mid)
        hitm = hitm | is_hit.astype(jnp.int32)
        done = done | is_hit.astype(jnp.int32) | is_miss.astype(jnp.int32)
        adv = live & (done < 1)
        new_len = jnp.where(fail, step_len * (1.0 - omega), dist * omega)
        omega = jnp.where(fail, 1.0, omega)
        prev_r = jnp.where(adv, jnp.abs(dist), prev_r)
        step_len = jnp.where(adv, jnp.abs(new_len), step_len)
        t = jnp.where(adv, t + new_len, t)
        out = (t, mid, hitm, done, step + 1, omega, prev_r, step_len)
        if with_steps:
            return out + (steps + live.astype(jnp.int32),)
        return out

    init = (t0, mid0, hit0, done0, jnp.int32(0), om0, zero, zero)
    if with_steps:
        out = lax.while_loop(cond, body, init + (steps0,))
    else:
        out = lax.while_loop(cond, body, init)
    t, mid, hitm = out[0], out[1], out[2]
    hit_b = hitm > 0
    t = jnp.where(hit_b, t, tmax)
    mid = jnp.where(hit_b, mid, -1)
    if with_steps:
        return t, mid, hit_b, out[8]
    return t, mid, hit_b


def get_normal(scene: Scene, params, cfg: RenderConfig, p: Vec3) -> Vec3:
    """SDF gradient normal.

    Default (`normal_taps=6`): central differences — parity with
    `getNormal` (`RayMarch.glsl:259-268`; ε = 0.001).
    Opt-in (`normal_taps=4`): tetrahedron differences (same O(ε²) accuracy,
    4 map evals instead of 6 — the standard SDF-renderer trick).
    Opt-in (`normal_taps=0`): the EXACT SDF gradient ∇map via one
    reverse-mode sweep (`jax.vjp`) — the ε→0 limit of both stencils at
    ~2 map-eval cost (the scene map is elementwise jnp, so the vjp
    legalizes inside the Pallas kernel like any other traced code)."""
    e = cfg.normal_eps
    md = lambda q: scene.map_dist(params, q, cfg.max_dist)  # noqa: E731
    shape = jnp.shape(p.x)
    if cfg.normal_taps == 0:
        f = lambda x, y, z: md(Vec3(x, y, z))  # noqa: E731
        _, pull = jax.vjp(f, p.x, p.y, p.z)
        gx, gy, gz = pull(jnp.ones(shape, jnp.float32))
        return Vec3(gx, gy, gz).normalized()
    if cfg.normal_taps == 4:
        n = Vec3.zeros(shape)
        for kx, ky, kz in ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0),
                           (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0)):
            k = Vec3.full(shape, kx, ky, kz)
            n = n + k * md(p + k * e)
        return n.normalized()
    ex = Vec3.full(shape, e, 0.0, 0.0)
    ey = Vec3.full(shape, 0.0, e, 0.0)
    ez = Vec3.full(shape, 0.0, 0.0, e)
    n = Vec3(md(p + ex) - md(p - ex),
             md(p + ey) - md(p - ey),
             md(p + ez) - md(p - ez))
    return n.normalized()


class _TraceState(NamedTuple):
    o: Vec3
    d: Vec3
    color: Vec3       # multiplicative throughput (starts at `channels`)
    extra: Vec3       # additive radiance from next-event estimation
    inside: jax.Array  # float 0/1
    active: jax.Array  # int32 0/1
    miss_thr: Vec3    # defer_sky mode: throughput at the miss event
    miss_dir: Vec3    # defer_sky mode: the miss direction


def _direct_light(scene: Scene, params, cfg: RenderConfig, hitp: Vec3,
                  normal: Vec3, throughput: Vec3, albedo: Vec3,
                  rng: RNGStream, mask, save_name: bool = False,
                  shadow_march=None):
    """Next-event estimation against the scene's sphere lights with a shadow
    march — the gen-2 direct-light pattern (`RayMarch2.glsl:480-501`):
    contribution = T · (albedo/π) · cos⁺ · power/dist², gated by a march
    toward a jittered point on the light (soft shadows)."""
    total = Vec3.zeros(jnp.shape(hitp.x))
    for li in range(scene.n_lights):
        lrng = rng.fork(101 + li)
        lpos, lpower, lradius = scene.light(params, li)
        jit = uniform_sphere(lrng.next(), lrng.next()) * lradius
        target = lpos + jit
        delta = target - hitp
        dist_l = delta.length()
        ldir = delta / jnp.maximum(dist_l, 1e-8)
        o_sh = hitp + normal * cfg.surface_offset
        ones = jnp.ones(jnp.shape(hitp.x), jnp.float32)
        # Shadow visibility is binary — detach its march so reverse-mode
        # never tries to transpose the while_loop (gradients still flow via
        # the cos/falloff/albedo terms).  t_max = the light distance: the
        # visibility march stops AT the light instead of burning the whole
        # max_steps budget (sd == dist_l on an unobstructed ray → lit).
        # The light index is forwarded so recorded-mode shadow lookups can
        # index their per-(bounce, light) plane.
        shadow = shadow_march if shadow_march is not None else (
            lambda o, d, m, a, tm, _li: march(
                scene, lax.stop_gradient(params), cfg, o, d, m, a,
                t_max=tm))
        sd, _, _ = shadow(lax.stop_gradient(o_sh), lax.stop_gradient(ldir),
                          ones, mask, lax.stop_gradient(dist_l), li)
        if save_name:
            # remat-saveable (diff mode only — the `name` primitive must not
            # appear inside Pallas kernel traces): the shadow march replay
            # is skipped by `diff.march.march_save_policy()`
            from jax.ad_checkpoint import checkpoint_name
            sd = checkpoint_name(sd, "shadow_t")
        lit = sd >= dist_l
        cos_t = jnp.maximum(ldir.dot(normal), 0.0)
        fall = lpower / jnp.maximum(dist_l * dist_l, 1e-8)
        contrib = throughput * albedo * (cos_t * fall / _PI)
        total = total + vselect(lit & mask, contrib, Vec3.zeros(jnp.shape(hitp.x)))
    return total


def trace_rgb(scene: Scene, params, cfg: RenderConfig, eye: Vec3, d0: Vec3,
              px, py, sample, channels: Vec3,
              direct_light: bool = False,
              differentiable: bool = False,
              defer_sky: bool = False,
              march_impl: str = "oracle",
              recorded=None):
    """Gen-1 `trace` (`RayMarch.glsl:483-565`), fully masked.

    Paths terminate on emission (dir == 0), on sky miss, or after
    max_bounces; throughput multiplies material colors; `inside` flips the
    march direction multiplier for dielectric interiors.

    `differentiable=True` swaps the march for the reparameterized-adjoint
    version (`diff.march_diff`) so `jax.grad` flows through hit geometry to
    scene parameters (inverse rendering, BASELINE config 4).

    `defer_sky=True` skips the sky evaluation and instead returns
    (color, miss_thr, miss_dir): the caller composites
    `color + miss_thr * sky(miss_dir)` itself (the deferred-sky contract
    of the env-map kernels, `kernels/march.py`).

    `march_impl="recorded"` (with `differentiable=True`) replays the
    marches banked by `kernels.record.trace_record_fused`."""
    shape = jnp.shape(d0.x)
    ones = jnp.ones(shape, jnp.float32)
    if march_impl == "recorded":
        # recorded mode (`kernels.record.trace_record_fused`): the whole
        # forward trace already ran as ONE Pallas launch; every march and
        # shadow march is a bank lookup here, gradients attach via the
        # shared implicit adjoint.  Requires `differentiable=True`.  The
        # replay runs as a lax.scan over bounces with the bank slices as
        # scanned inputs (rec_b below) — a static unroll made the XLA
        # graph (and its reverse-mode double) O(max_bounces · n_lights)
        # and compiled in minutes at multi-chip dryrun shapes.
        if recorded is None:
            raise ValueError("march_impl='recorded' needs recorded planes")
        if not differentiable:
            raise ValueError("recorded mode is the differentiable forward; "
                             "use the fused kernel for plain rendering")
        from raymarchrenderer.diff.march import march_diff_recorded

        L = scene.n_lights

        def make_march_fn(rec_b):
            def march_fn(o, d, dist_mult, active):
                return march_diff_recorded(
                    scene, cfg, params, o, d, active,
                    rec_b["t"], rec_b["mid"], rec_b["hit"])
            return march_fn

        def make_shadow_fn(rec_b):
            from jax.ad_checkpoint import checkpoint_name

            def shadow_fn(o, d, m, a, tm, li):
                sd = checkpoint_name(rec_b["sd"][li], "shadow_t")
                return sd, None, None
            return shadow_fn

        def rec_slice(b):
            """Bank slices for a STATIC bounce index (the bounce-0 peel)."""
            out = {"t": recorded["t"][b], "mid": recorded["mid"][b],
                   "hit": recorded["hit"][b]}
            if "sd" in recorded:
                out["sd"] = recorded["sd"][b * L:(b + 1) * L]
            return out
    elif differentiable:
        from raymarchrenderer.diff.march import march_diff

        def march_fn(o, d, dist_mult, active):
            return march_diff(scene, cfg, params, o, d, dist_mult, active)
    else:
        def march_fn(o, d, dist_mult, active):
            return march(scene, params, cfg, o, d, dist_mult, active)

    def body(b, st: _TraceState, rec_b=None):
        dist_mult = 1.0 - 2.0 * st.inside
        active_b = st.active > 0
        if march_impl == "recorded":
            t, mid, hitm = make_march_fn(rec_b)(st.o, st.d, dist_mult,
                                                active_b)
        else:
            t, mid, hitm = march_fn(st.o, st.d, dist_mult, active_b)
        hitp = st.o + st.d * t
        normal = get_normal(scene, params, cfg, hitp)
        rng = RNGStream(cfg.seed, px, py, sample, b)
        ctx = ShadeCtx(st.o, st.d, t, hitp, st.inside, normal, channels, rng)
        s = scene.shade(params, ctx, mid)

        hit_active = active_b & hitm
        miss_active = active_b & ~hitm
        if defer_sky:
            # record the miss event; radiance composited by the caller
            miss_thr = vselect(miss_active, st.color, st.miss_thr)
            miss_dir = vselect(miss_active, st.d, st.miss_dir)
            zeros = Vec3.zeros(shape)
            mult = vselect(hit_active, s.color,
                           vselect(miss_active, zeros,
                                   Vec3(ones, ones, ones)))
        else:
            miss_thr, miss_dir = st.miss_thr, st.miss_dir
            sky = scene.sky(params, st.d)
            mult = vselect(hit_active, s.color,
                           vselect(miss_active, sky,
                                   Vec3(ones, ones, ones)))
        color = st.color * mult

        new_inside_b = s.inside.x > 0.5
        inside = jnp.where(hit_active, new_inside_b.astype(jnp.float32),
                           st.inside)
        term = (s.dir.x == 0.0) & (s.dir.y == 0.0) & (s.dir.z == 0.0)
        active = hit_active & ~term

        extra = st.extra
        if direct_light and scene.n_lights:
            sm = (make_shadow_fn(rec_b) if march_impl == "recorded"
                  else None)
            extra = extra + _direct_light(
                scene, params, cfg, hitp, normal, st.color, s.color,
                rng.fork(7), hit_active & ~term, save_name=differentiable,
                shadow_march=sm)

        if cfg.rr_start_bounce >= 0:
            # Russian roulette (`RayMarch2.glsl:480-501` semantics): a
            # continuing path survives with p = clip(max throughput, pmin, 1);
            # survivors carry throughput/p, casualties contribute nothing
            # (their radiance would have come from a later emission event).
            p = jnp.clip(jnp.maximum(color.x, jnp.maximum(color.y, color.z)),
                         cfg.rr_min_prob, 1.0)
            u = rng.fork(13).next()
            do_rr = jnp.logical_and(active, b >= cfg.rr_start_bounce)
            kill = do_rr & (u >= p)
            scale = jnp.where(do_rr & ~kill, 1.0 / p, 1.0)
            color = vselect(kill, Vec3.zeros(shape), color * scale)
            active = active & ~kill

        override = (s.hit.x != 0.0) | (s.hit.y != 0.0) | (s.hit.z != 0.0)
        off = jnp.where(new_inside_b, -cfg.inside_offset, cfg.exit_offset)
        o_next = vselect(override, s.hit, hitp + normal * off)
        o = vselect(active, o_next, st.o)
        d = vselect(active, s.dir, st.d)
        return _TraceState(o, d, color, extra, inside,
                           active.astype(jnp.int32), miss_thr, miss_dir)

    init = _TraceState(
        o=eye, d=d0, color=channels, extra=Vec3.zeros(shape),
        inside=jnp.zeros(shape, jnp.float32),
        active=jnp.ones(shape, jnp.int32),
        miss_thr=Vec3.zeros(shape), miss_dir=Vec3.zeros(shape))
    # Bounce 0 is peeled out of the loop (it always runs — every ray starts
    # active), so the loop starts from an already-computed state.
    if march_impl == "recorded":
        st0 = body(0, init, rec_slice(0))
        B = cfg.max_bounces
        n_l = L if direct_light else 0
        # Hybrid replay schedule:
        #   * UNROLL only for the no-NEE small-B case — the train-bench
        #     default — where XLA fuses across bounces and the graph
        #     stays small;
        #   * SCAN everywhere else: the unrolled graph (and its
        #     reverse-mode double) is O(B·L·scene-size) and compiles in
        #     minutes off the small case, while scan pays carry
        #     round-trips.
        if n_l == 0 and B <= 4:
            out = st0
            for b in range(1, B):
                out = body(b, out, rec_slice(b))
        else:
            # bank slices ride the scan xs; the bounce index is traced
            # (the RNG hash and the RR gate are elementwise in it)
            xs = {"b": jnp.arange(1, B, dtype=jnp.int32),
                  "t": recorded["t"][1:], "mid": recorded["mid"][1:],
                  "hit": recorded["hit"][1:]}
            if "sd" in recorded:
                sd_shape = recorded["sd"].shape
                xs["sd"] = recorded["sd"].reshape(B, L, *sd_shape[1:])[1:]

            def scan_body(st, x):
                return body(x["b"], st, x), None

            out, _ = lax.scan(scan_body, st0, xs)
        if defer_sky:
            return out.color + out.extra, out.miss_thr, out.miss_dir
        return out.color + out.extra
    st0 = body(0, init)
    if differentiable:
        # reverse-mode needs a statically-bounded loop (while_loop has no
        # transpose rule)
        out = lax.fori_loop(1, cfg.max_bounces, body, st0)
    else:
        # Early-exit bounce loop: once every lane in the batch/tile has
        # terminated (emitter hit, sky miss, or mix kill) the remaining
        # bounces are skipped entirely.  Most paths die in 1-3 bounces, so
        # inside the Pallas kernel — where the batch is one 2D tile — this
        # skips the per-bounce normal estimate (6 map evals) and shade for
        # the vast majority of the 16-bounce budget.
        def wcond(carry):
            b, st = carry
            return (b < cfg.max_bounces) & (jnp.max(st.active) > 0)

        def wbody(carry):
            b, st = carry
            return b + 1, body(b, st)

        _, out = lax.while_loop(wcond, wbody, (jnp.int32(1), st0))
    # paths still active after max_bounces return their bare albedo product,
    # exactly like the reference's loop falling off the end (RayMarch.glsl:493)
    if defer_sky:
        return out.color + out.extra, out.miss_thr, out.miss_dir
    return out.color + out.extra


def render_patch(scene: Scene, params, cfg: RenderConfig, corners,
                 origin_xy, patch_shape, sample,
                 direct_light: bool = False,
                 differentiable: bool = False,
                 march_impl: str = "oracle",
                 interpret: bool = False) -> Vec3:
    """One sample of a rectangular pixel patch with *dynamic* origin and
    *static* shape — the unit of work shared by tile scheduling and by
    tile sharding across chips.  Because the RNG is keyed on absolute pixel
    coordinates, any patch decomposition is bitwise-identical to the full
    frame."""
    ph, pw = patch_shape
    ox, oy = origin_xy[0], origin_xy[1]
    py = jnp.broadcast_to(jnp.arange(ph, dtype=jnp.int32)[:, None] + oy,
                          (ph, pw))
    px = jnp.broadcast_to(jnp.arange(pw, dtype=jnp.int32)[None, :] + ox,
                          (ph, pw))
    rng = RNGStream(cfg.seed, px, py, sample, jnp.uint32(1 << 20))
    d = primary_rays(corners, px, py, cfg.width, cfg.height, rng)
    e = eye_vec(corners)
    eye = Vec3(jnp.broadcast_to(e.x, (ph, pw)),
               jnp.broadcast_to(e.y, (ph, pw)),
               jnp.broadcast_to(e.z, (ph, pw)))
    recorded = None
    if march_impl == "recorded":
        from raymarchrenderer.kernels.record import trace_record_fused
        recorded = trace_record_fused(scene, params, cfg, corners,
                                      origin_xy, patch_shape, sample,
                                      direct_light=direct_light,
                                      interpret=interpret)
    if not cfg.separate_channels:
        channels = Vec3.full((ph, pw), 1.0, 1.0, 1.0)
        return trace_rgb(scene, params, cfg, eye, d, px, py, sample,
                         channels, direct_light, differentiable,
                         march_impl=march_impl, recorded=recorded)
    total = Vec3.zeros((ph, pw))
    for ci, mask in enumerate(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                               (0.0, 0.0, 1.0))):
        channels = Vec3.full((ph, pw), *mask)
        s_id = sample * jnp.uint32(4) + jnp.uint32(ci + 1)
        # dispersion recording: the recorder banked per-channel
        # paths — slice channel ci's (B, H, W) planes for this replay
        rec_ci = (None if recorded is None
                  else {k: recorded[k][ci] for k in recorded})
        total = total + trace_rgb(scene, params, cfg, eye, d, px, py,
                                  s_id, channels, direct_light,
                                  differentiable,
                                  march_impl=march_impl, recorded=rec_ci)
    return total


def render_patch_spp(scene: Scene, params, cfg: RenderConfig, corners,
                     origin_xy, patch_shape, sample0, n_samples: int,
                     direct_light: bool = False,
                     differentiable: bool = False,
                     march_impl: str = "oracle",
                     interpret: bool = False) -> Vec3:
    """All `n_samples` samples of a patch in ONE batched trace.

    The sample axis is folded into the row axis — ray planes are
    (n_samples·ph, pw) — so every march covers every sample at once: one
    Pallas launch per bounce instead of one per (sample, bounce), fully
    vectorized shading, and (in diff mode) one remat region for the whole
    sample batch.  This replaces the reference's serial per-sample dispatch
    loop (`Program.cpp:249-259`) for the training path the same way the
    megakernel's in-loop regeneration replaces it for the forward path.

    Because the RNG is keyed on absolute (pixel, sample) coordinates the
    result is the same sample set as `n_samples` calls of `render_patch`
    (identical per-sample radiance; the cross-sample reduction here is a
    single axis-sum).  Returns the per-pixel SUM over samples — the caller
    normalizes, mirroring `render_fused_patch(normalize=False)`."""
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

    def reduce(v: Vec3) -> Vec3:
        return Vec3(v.x.reshape(S, ph, pw).sum(0),
                    v.y.reshape(S, ph, pw).sum(0),
                    v.z.reshape(S, ph, pw).sum(0))

    recorded = None
    if march_impl == "recorded":
        # ONE Pallas launch runs the entire multi-bounce (and shadow)
        # march; each lane traces its S samples with in-loop regeneration
        # (the megakernel's straggler amortization) and the recorder
        # returns the banks already reshaped to this function's
        # sample-folded layout.  The trace below is a pure XLA shade
        # replay over the recorded geometry.
        from raymarchrenderer.kernels.record import trace_record_fused
        recorded = trace_record_fused(scene, params, cfg, corners,
                                      origin_xy, patch_shape, sample0,
                                      direct_light=direct_light,
                                      interpret=interpret, n_samples=S)

    if not cfg.separate_channels:
        channels = Vec3.full(shape, 1.0, 1.0, 1.0)
        return reduce(trace_rgb(scene, params, cfg, eye, d, px, py, sample,
                                channels, direct_light, differentiable,
                                march_impl=march_impl, recorded=recorded))
    total = Vec3.zeros(shape)
    for ci, mask in enumerate(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                               (0.0, 0.0, 1.0))):
        channels = Vec3.full(shape, *mask)
        s_id = sample * jnp.uint32(4) + jnp.uint32(ci + 1)
        rec_ci = (None if recorded is None
                  else {k: recorded[k][ci] for k in recorded})
        total = total + trace_rgb(scene, params, cfg, eye, d, px, py,
                                  s_id, channels, direct_light,
                                  differentiable,
                                  march_impl=march_impl, recorded=rec_ci)
    return reduce(total)


def render_sample(scene: Scene, params, cfg: RenderConfig, corners,
                  sample, direct_light: bool = False,
                  differentiable: bool = False) -> Vec3:
    """One full-frame sample (all pixels, 1 spp) — the body of one
    `Graphics::Render` dispatch (`Graphics.cpp:314-354`) without tiling."""
    px, py = pixel_grid(cfg.width, cfg.height)
    rng = RNGStream(cfg.seed, px, py, sample, jnp.uint32(1 << 20))
    d = primary_rays(corners, px, py, cfg.width, cfg.height, rng)
    shape = (cfg.height, cfg.width)
    e = eye_vec(corners)
    eye = Vec3(jnp.broadcast_to(e.x, shape), jnp.broadcast_to(e.y, shape),
               jnp.broadcast_to(e.z, shape))

    if not cfg.separate_channels:
        channels = Vec3.full(shape, 1.0, 1.0, 1.0)
        return trace_rgb(scene, params, cfg, eye, d, px, py, sample,
                         channels, direct_light, differentiable)
    # dispersion mode: trace R, G, B separately and sum
    # (`RayMarch.glsl:586-598`); fold the channel into the RNG sample id so
    # the three traces draw independent streams.
    total = Vec3.zeros(shape)
    for ci, mask in enumerate(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                               (0.0, 0.0, 1.0))):
        channels = Vec3.full(shape, *mask)
        s_id = sample * jnp.uint32(4) + jnp.uint32(ci + 1)
        total = total + trace_rgb(scene, params, cfg, eye, d, px, py,
                                  s_id, channels, direct_light,
                                  differentiable)
    return total


def accumulate(accum, color: Vec3, n):
    """Progressive running mean (`RayMarch.glsl:600-612`):
    new/(n+1) + old·n/(n+1).  `accum` is an (H, W, 3) array."""
    f1 = 1.0 / (n + 1.0)
    f2 = n / (n + 1.0)
    return color.stack(-1) * f1 + accum * f2


@functools.partial(jax.jit, static_argnums=(0, 2, 6))
def _sample_step(scene, params, cfg, corners, accum_n, sample,
                 direct_light=False):
    accum, n = accum_n
    color = render_sample(scene, params, cfg, corners, sample, direct_light)
    return accumulate(accum, color, n), n + 1.0


def render(scene: Scene, params, cfg: RenderConfig, corners,
           spp: int = None, direct_light: bool = False,
           accum=None, n0: float = 0.0, callback=None):
    """Progressive render: `spp` samples accumulated into a running mean.

    Restartable: pass (`accum`, `n0`) from a checkpoint to resume — the
    accumulation buffer IS the checkpoint (SURVEY.md §5).  Returns
    (image (H,W,3) float32 linear, n_samples)."""
    spp = cfg.spp if spp is None else spp
    if accum is None:
        accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    n = jnp.float32(n0)
    state = (accum, n)
    for s in range(int(n0), int(n0) + spp):
        state = _sample_step(scene, params, cfg, corners, state,
                             jnp.uint32(s), direct_light)
        if callback is not None:
            callback(s, state)
    accum, n = state
    return accum, float(n)
