"""Megakernel path tracer: one unified march+shade loop, per-lane bounces,
in-loop sample regeneration.

The wavefront integrator (`render.integrator.trace_rgb`) synchronizes the
whole batch at every bounce boundary: bounce b's march runs until the LAST
lane of the tile converges, so the total step count is Σ_b max_lanes(steps_b).
On a 2015 GPU that is the natural shape (the reference redispatches per
sample anyway, `Program.cpp:249-259` → `RayMarch3.glsl:356` runs the bounce
loop per thread); in a SIMD block the per-bounce barrier is pure waste —
the straggler lanes of different bounces are DIFFERENT lanes.

This module restates the same per-pixel pipeline (`RayMarch.glsl:483-565`)
as a *megakernel*: every lane carries its own (ray, throughput, bounce
index, sample index, lane state) and a single outer `while_loop` runs until
every lane has finished every sample.  Three scheduling ideas stack:

  1. per-lane bounce progression — tile cost is the straggler of the sum,
     not the sum of per-bounce stragglers;
  2. batched shade passes — shading (SDF-gradient normal + material graph +
     RNG, ~10× a march step) runs once per `march_unroll`-step chunk:
     unconditionally when `shade_gate<=0` (no reductions, the measured
     optimum with the relaxed march), else under `lax.cond` when parked
     lanes outnumber marchers by the gate ratio;
  3. path regeneration over samples — a lane whose path terminates starts
     its NEXT sample immediately instead of idling until the tile's
     stragglers finish, so straggler cost amortizes across all spp
     (`n_samples`), plus `march_unroll` masked march steps per loop
     iteration to slash loop-carry/reduction overhead.

All three are pure scheduling: every random draw is keyed on (seed, px, py,
sample, bounce, slot) exactly like the oracle — `sample`/`bounce` are
per-lane arrays here and loop scalars there, but the hash is elementwise,
so the streams are bitwise identical and the accumulated result equals the
oracle's per-sample sum in the same order, to the last ulp.  Tested in
`tests/test_mega.py`.

Used by `kernels/march.py` and `kernels/record.py` inside the fused
Pallas kernels; also runs as plain jnp (whole-frame XLA).  `trace_mega_spectral`
is the gen-3 twin: the same schedule over (wavelength, power) lane state
(`RayMarch3.glsl` transport), used by `render_fused_spectral`.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from raymarchrenderer.core.rng import RNGStream
from raymarchrenderer.core.sampling import (uniform_sphere,
                                                uniform_sphere_or_hemisphere)
from raymarchrenderer.core.vecmath import Vec3, vselect
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import get_normal
from raymarchrenderer.render.raygen import eye_vec, primary_rays
from raymarchrenderer.scene.graph import Scene
from raymarchrenderer.scene.nodes import ShadeCtx

_PI = 3.14159265358979323846  # same literal as integrator._direct_light

# Lane states (int32 carries).
_MARCH = 0   # sphere-tracing the current ray segment
_WAIT = 1    # hit found, parked until the next shade pass
_REGEN = 2   # path finished, parked until the pass banks it / respawns
# NEE only (`direct_light=True`): the shadow march toward the current
# light runs as just another march segment of the SAME loop — a lane in
# _SHADOW sphere-traces (sh_o, sh_d) capped at seg_tmax (the light
# distance) and parks as _SH_OCC (hit something first → occluded) or
# _SH_LIT (reached the light / budget → lit, matching the oracle march's
# exhaustion-returns-t_max semantics); the resolve pass banks the pending
# contribution and chains to the next light or resumes the bounce ray.
_SHADOW = 4
_SH_LIT = 5
_SH_OCC = 6
_EXH = 7     # all samples done — the LARGEST state so `min(state) < _EXH`
#              means "some lane alive" with every other state below it
# spectral only: a parked MISS (the sky is an emitter band, so misses also
# go through the shade pass).  Negative so `min(state) < _EXH` still means
# "some lane alive" — encoding hit/miss in the state drops the separate
# `hitm` carry and its per-step select.
_WAIT_MISS = -1


def _init_banks(specs, shape, refs):
    """Banks of per-(slot, pixel) records: `specs` holds one
    (depth, init value, dtype) per bank.  Plain jnp carries them as stacked
    (depth, h, w) loop carries.  In a kernel (`refs` = the block's bank
    writer, `kernels.march.BankRefs`) nothing is carried: every slot the
    block owns is filled with its init value here (kernel outputs start
    uninitialised) and later records are stored straight into them."""
    if refs is None:
        return tuple(jnp.full((k,) + shape, v, dt) for k, v, dt in specs)
    for i, (k, v, dt) in enumerate(specs):
        def fill(s, c, i=i, v=v, dt=dt):
            refs.fill(i, s, jnp.full(shape, v, dt))
            return c
        lax.fori_loop(0, k, fill, 0)
    return ()


def _write_banks(rec, refs, which, slot, mask, values):
    """Record `values[i]` in bank `which[i]` at (slot, y, x) where `mask`.

    Carried banks take a one-hot select over the slot axis; in a kernel
    each record is ONE masked store through the bank writer, so bank
    depth costs no registers and needs no power-of-two size."""
    if refs is None:
        kk = lax.broadcasted_iota(jnp.int32, rec[which[0]].shape, 0)
        sel = mask[None] & (slot[None] == kk)
        rec = list(rec)
        for w, v in zip(which, values):
            rec[w] = jnp.where(sel, v[None], rec[w])
        return tuple(rec)
    for w, v in zip(which, values):
        refs.store(w, slot, v, mask)
    return rec


class _MegaState(NamedTuple):
    o: Vec3            # current segment origin
    d: Vec3            # current segment direction
    t: jax.Array       # distance along segment
    thr: Vec3          # multiplicative throughput of the current path
    acc: Vec3          # banked sum over finished samples
    inside: jax.Array  # float 0/1 dielectric-interior flag
    bounce: jax.Array  # int32 per-lane bounce index
    s_idx: jax.Array   # int32 per-lane sample index
    state: jax.Array   # int32 lane state
    steps: jax.Array   # int32 steps spent on current segment
    # over-relaxation carries (cfg.relax_omega > 1; identity updates — and
    # therefore free — when disabled): per-lane ω, previous unbounding-sphere
    # radius, and last step length of the current segment
    omega: jax.Array
    prev_r: jax.Array
    step_len: jax.Array
    # NEE carries (None — i.e. absent from the pytree/loop — unless
    # direct_light): the active shadow segment, its pending contribution,
    # the per-path additive NEE radiance, the post-shadow resume state,
    # the light counter, and the not-yet-marched lights' precomputed
    # (dir, t_max, contrib) stash (a tuple of n_lights-1 entries)
    # scalar global march-step counter (lazy_miss only): st.steps then
    # stores the per-lane gstep snapshot at segment start and the live
    # count is gstep - steps (see _SpecState for the full rationale)
    gstep: jax.Array = None
    sh_o: Vec3 = None          # shadow ray origin (hitp + n*surface_offset)
    sh_d: Vec3 = None          # shadow ray direction (current light)
    seg_tmax: jax.Array = None  # march cap: light distance / max_dist
    contrib: Vec3 = None       # pending contribution of the current light
    extra: Vec3 = None         # banked NEE radiance of the current path
    resume: jax.Array = None   # int32 state to resume after the shadows
    li: jax.Array = None       # int32 current light index
    sh_store: tuple = ()       # ((d, tmax, contrib), ...) for lights 1..
    # banks carried by plain jnp (empty inside a kernel, which stores them
    # through its bank writer — `_write_banks`).  record_banks: (t (B·S, h, w)
    # f32, mid i32, hit i32[, sd (B·S·L, h, w) f32]), the per-(bounce,
    # sample) march residuals the differentiable replay consumes
    # (`kernels.record.trace_record_fused`).  defer_sky: (thr r, g, b
    # (P, h, w) f32, packed uv i32), one miss event per path slot.
    rec: tuple = ()


def trace_mega_paths(scene: Scene, params, cfg: RenderConfig, corners,
                     px, py, sample0, channels: Vec3, n_samples: int = 1,
                     shade_gate: float = 32.0,
                     march_unroll: int = 1,
                     dispersion: bool = False,
                     direct_light: bool = False,
                     record_banks: bool = False,
                     defer_sky: bool = False,
                     lazy_miss: bool = False,
                     regen_cadence: int = 0,
                     bank_refs=None):
    """Sum of `n_samples` samples per pixel (regenerated in-loop), equal to
    Σ_s trace_rgb(sample0+s) to float32 rounding.  Forward only —
    `lax.while_loop` has no transpose; use `trace_rgb(differentiable=True)`
    for gradients.

    `dispersion=True` restates the gen-1 `separateChannels` mode
    (`RayMarch.glsl:580-598`) inside the megakernel: the lane's path counter
    enumerates (sample, channel) pairs — 3·n_samples paths per pixel — with
    the channel folded into the regeneration loop.  Channel ci of sample s
    shares s's primary ray (dispersion splits at the first chromatic
    interaction, not at the camera) and draws the shade stream
    `s·4 + ci + 1`, exactly the oracle's keying
    (`render.integrator.render_patch`), so the accumulated sum equals the
    oracle's per-channel sum up to float32 re-association (the oracle adds
    R+G+B per sample before banking; here each channel banks separately).

    `lazy_miss` / `regen_cadence`: the per-step op-count knobs, same
    contracts as on `trace_mega_spectral` — lazy_miss moves the per-step
    miss test (and the miss-time sky multiply) to pass boundaries
    (converged-equal; bitwise when geometry is well inside max_dist and
    the step budget never binds); regen_cadence=k adds a CHEAP pass every
    k steps that retires parked misses/finished paths (and, under NEE,
    resolves parked shadow segments) without the full shade pass's map +
    normal + material ops — bitwise (pure scheduling).  Both compose
    with record_banks: the recorded banks are identical under
    the cadence, and identical under lazy_miss on scenes where the
    max_dist/step-budget shell never binds — see the note at the
    lazy_miss validation below; NEE recording is forced strict by the
    caller (`kernels.record._record_mega`).

    `bank_refs`: inside a kernel, the writer the record / deferred-sky
    banks are stored through (`kernels.march.BankRefs`, see
    `_write_banks`); the banks are then not returned.  Plain jnp carries
    them and returns them."""
    shape = jnp.shape(px)
    e = eye_vec(corners)
    eye = Vec3(jnp.broadcast_to(e.x, shape).astype(jnp.float32),
               jnp.broadcast_to(e.y, shape).astype(jnp.float32),
               jnp.broadcast_to(e.z, shape).astype(jnp.float32))
    s0 = jnp.asarray(sample0).astype(jnp.uint32)
    n_paths = n_samples * 3 if dispersion else n_samples

    if dispersion:
        def lane_streams(s_idx):
            """(primary stream, shade stream) for path counter s_idx."""
            samp = s0 + (s_idx // 3).astype(jnp.uint32)
            ci = (s_idx % 3).astype(jnp.uint32)
            return samp, samp * jnp.uint32(4) + ci + jnp.uint32(1)

        def lane_channels(s_idx):
            ci = s_idx % 3
            return Vec3((ci == 0).astype(jnp.float32),
                        (ci == 1).astype(jnp.float32),
                        (ci == 2).astype(jnp.float32))
    else:
        def lane_streams(s_idx):
            s = s0 + s_idx.astype(jnp.uint32)
            return s, s

        def lane_channels(s_idx):
            return channels

    def primary(s_idx):
        s_prim, _ = lane_streams(s_idx)
        rng = RNGStream(cfg.seed, px, py, s_prim, jnp.uint32(1 << 20))
        return primary_rays(corners, px, py, cfg.width, cfg.height, rng)

    relax = cfg.relax_omega > 1.0
    nee = direct_light and scene.n_lights > 0
    # record_banks + dispersion: the path counter already
    # enumerates (sample, channel) pairs, so the banks get slot
    # b·3S + (3s + ci) for free; the recorder's caller folds them into
    # per-channel (B, S·H, W) planes for the replay's channel loop.
    if record_banks and defer_sky:
        raise ValueError("record_banks and defer_sky are exclusive modes")
    # record_banks composes with BOTH schedule knobs.  regen_cadence is
    # pure scheduling (resolve/regen compute the same per-lane values
    # whenever they run), so recorded banks are identical under it up to
    # unrolled-step fusion ulps (tested: ids/hit/visibility exact, t to
    # 1 ulp), so the recorder runs it.  lazy_miss is
    # the render's O(rare-lane) estimator trade (a lane grazing geometry
    # AT the max_dist shell can resolve differently): banks are bitwise-
    # identical on scenes whose geometry sits well inside max_dist
    # (tested), so the train path may opt in for the render schedule's
    # occupancy — it stays OFF by default for recording.
    if (regen_cadence and regen_cadence < march_unroll
            and march_unroll % regen_cadence):
        # cadence >= unroll simply means "no mid-chunk pass" (body() only
        # splits when regen_cadence < march_unroll), so a caller overriding
        # the unroll below the default cadence is fine
        raise ValueError("regen_cadence must divide march_unroll")
    B = cfg.max_bounces
    L = scene.n_lights if nee else 0
    _one_minus_omega = float(np.float32(1.0) - np.float32(cfg.relax_omega))
    # record mode traces geometry only: the color output is discarded and
    # a missed path terminates (sky never feeds a later RR/shade decision),
    # so skip the sky eval — which is what lets ENV-MAP scenes record
    # in-kernel (the equirect gather stays in the XLA replay)
    skip_sky = defer_sky or record_banks

    def march_step(st: _MegaState) -> _MegaState:
        marching = st.state == _MARCH
        if nee:
            # shadow segments march in the SAME loop: select the lane's
            # active segment (bounce ray vs shadow ray toward the light)
            shadow = st.state == _SHADOW
            seg = marching | shadow
            o_seg = vselect(shadow, st.sh_o, st.o)
            d_seg = vselect(shadow, st.sh_d, st.d)
            dist_mult = jnp.where(shadow, 1.0, 1.0 - 2.0 * st.inside)
            tmax = st.seg_tmax
        else:
            seg = marching
            o_seg, d_seg = st.o, st.d
            dist_mult = 1.0 - 2.0 * st.inside
            tmax = cfg.max_dist
        p = o_seg + d_seg * st.t
        # distance-only map in the hot loop; the material id is recovered
        # at the SAME hit point by the shade pass (one full map eval per
        # shade instead of id-selects on every march step) — bitwise
        # identical, the hit point does not move between march and shade
        dist = scene.map_dist(params, p, cfg.max_dist) * dist_mult
        if relax:
            # safeguarded over-relaxation (see integrator._march_relaxed):
            # a step is valid only if consecutive unbounding spheres overlap
            fail = seg & (st.omega > 1.0) & (
                dist + st.prev_r < st.step_len)
        else:
            fail = jnp.zeros(jnp.shape(st.t), bool)
        is_hit = seg & ~fail & (dist < cfg.hit_eps)
        if lazy_miss:
            # miss detection (and the miss-time sky multiply) deferred to
            # `mark_misses` at the pass/cadence boundary — the hot loop
            # carries only the hit test; the step budget rides the SCALAR
            # gstep counter (st.steps holds segment-start snapshots)
            upd = dict(gstep=st.gstep + 1)
            thr = st.thr
            if nee:
                # a shadow segment past its light (t >= seg_tmax) must NOT
                # occlude: without the strict per-step miss test the lane
                # keeps marching up to regen_cadence-1 extra steps and can
                # reach geometry BEHIND the light — a deterministic darkening
                # bias, not noise.  Mask those hits; mark_misses parks the
                # lane as _SH_LIT at the cadence boundary (t already >= tmax).
                is_hit = is_hit & (~shadow | (st.t < tmax))
                state = jnp.where(is_hit,
                                  jnp.where(shadow, _SH_OCC, _WAIT),
                                  st.state)
            else:
                state = jnp.where(is_hit, _WAIT, st.state)
            still = seg & ~is_hit
            if relax:
                # fail implies omega == relax_omega exactly, so
                # (1 - omega) is a trace-time constant (one fewer vector
                # op; f32 `1 - omega` is exact by Sterbenz, so bitwise)
                new_len = jnp.where(fail, st.step_len * _one_minus_omega,
                                    dist * st.omega)
                omega = jnp.where(fail, 1.0, st.omega)
                prev_r = jnp.where(still, jnp.abs(dist), st.prev_r)
                step_len = jnp.where(still, jnp.abs(new_len), st.step_len)
                t = jnp.where(still, st.t + new_len, st.t)
                return st._replace(t=t, thr=thr, state=state,
                                   omega=omega, prev_r=prev_r,
                                   step_len=step_len, **upd)
            t = jnp.where(still, st.t + dist * cfg.step_multiply, st.t)
            return st._replace(t=t, thr=thr, state=state, **upd)
        # unconditional: only marching lanes' counts are read (is_miss is
        # masked by `seg`) and every MARCH transition resets to 0
        steps = st.steps + 1
        upd = dict(steps=steps)
        # miss on the PRE-step t (parity with `march`, RayMarch.glsl:233-257)
        # or on step-budget exhaustion (march loop falling off the end).
        is_miss = seg & ~fail & ~is_hit & (
            (st.t >= tmax) | (steps >= cfg.max_steps))
        # defer_sky: the sky is an out-of-kernel equirect composite —
        # never trace the gather here; misses park as _WAIT_MISS and the
        # regen pass banks their (throughput, direction) event instead
        miss_state = _WAIT_MISS if defer_sky else _REGEN
        if not skip_sky:
            sky = scene.sky(params, st.d)
        if nee:
            bounce_miss = is_miss & ~shadow
            thr = (st.thr if skip_sky
                   else vselect(bounce_miss, st.thr * sky, st.thr))
            # shadow outcomes park for the resolve pass; budget exhaustion
            # counts as LIT (the oracle march returns t == t_max there)
            state = jnp.where(
                is_hit, jnp.where(shadow, _SH_OCC, _WAIT),
                jnp.where(is_miss, jnp.where(shadow, _SH_LIT, miss_state),
                          st.state))
        else:
            thr = (st.thr if skip_sky
                   else vselect(is_miss, st.thr * sky, st.thr))
            state = jnp.where(is_hit, _WAIT,
                              jnp.where(is_miss, miss_state, st.state))
        still = seg & ~is_hit & ~is_miss
        if relax:
            # (1 - omega) const-folded: see the lazy branch note
            new_len = jnp.where(fail, st.step_len * _one_minus_omega,
                                dist * st.omega)
            omega = jnp.where(fail, 1.0, st.omega)
            prev_r = jnp.where(still, jnp.abs(dist), st.prev_r)
            step_len = jnp.where(still, jnp.abs(new_len), st.step_len)
            t = jnp.where(still, st.t + new_len, st.t)
            return st._replace(t=t, thr=thr, state=state,
                               omega=omega, prev_r=prev_r,
                               step_len=step_len, **upd)
        t = jnp.where(still, st.t + dist * cfg.step_multiply, st.t)
        return st._replace(t=t, thr=thr, state=state, **upd)

    def shade(st: _MegaState) -> _MegaState:
        waiting = st.state == _WAIT
        hitp = st.o + st.d * st.t
        _, mid = scene.map(params, hitp, cfg.max_dist)
        if record_banks:
            # bank this hit's march residuals at the lane's
            # (bounce, sample) slot — slot = b·S + s, S = n_samples (the
            # in-loop regeneration amortizes stragglers across the lane's
            # samples exactly like the render megakernel).  Misses and
            # post-termination bounces never reach here — their slots
            # keep the init values (t=max_dist, mid=-1, hit=0), which are
            # exactly what the oracle march returns for missed / inactive
            # lanes, so the replay is residual-complete.
            S = n_paths
            slot = st.bounce * S + st.s_idx if S > 1 else st.bounce
            st = st._replace(rec=_write_banks(
                st.rec, bank_refs, (0, 1, 2), slot, waiting,
                (st.t, mid, jnp.ones(jnp.shape(mid), jnp.int32))))
        normal = get_normal(scene, params, cfg, hitp)
        _, s_id = lane_streams(st.s_idx)
        rng = RNGStream(cfg.seed, px, py, s_id, st.bounce)
        ctx = ShadeCtx(st.o, st.d, st.t, hitp, st.inside, normal,
                       lane_channels(st.s_idx), rng)
        s = scene.shade(params, ctx, mid)
        thr = vselect(waiting, st.thr * s.color, st.thr)
        new_inside_b = s.inside.x > 0.5
        inside = jnp.where(waiting, new_inside_b.astype(jnp.float32),
                           st.inside)
        term = (s.dir.x == 0.0) & (s.dir.y == 0.0) & (s.dir.z == 0.0)
        bounce = jnp.where(waiting, st.bounce + 1, st.bounce)
        done_now = term | (bounce >= cfg.max_bounces)
        # NEE contributions use the pre-roulette throughput (the oracle
        # computes `extra` before the RR scale/kill touches `color`)
        pre_rr_thr = thr
        if cfg.rr_start_bounce >= 0:
            # Russian roulette (`RayMarch2.glsl:480-501` semantics), keyed
            # exactly like the oracle (trace_rgb: u = rng.fork(13).next()
            # at bounce st.bounce): a continuing path survives with
            # p = clip(max throughput, pmin, 1); survivors carry thr/p,
            # casualties bank ZERO via the regen pass (their radiance
            # would have come from a later emission event).
            p = jnp.clip(jnp.maximum(thr.x, jnp.maximum(thr.y, thr.z)),
                         cfg.rr_min_prob, 1.0)
            u = rng.fork(13).next()
            # the oracle roulettes every non-terminated hit — including
            # paths at their final bounce (whose bare-albedo return is
            # then 1/p-scaled), so gate on ~term, NOT on ~done_now
            continuing = waiting & ~term
            do_rr = continuing & (st.bounce >= cfg.rr_start_bounce)
            kill = do_rr & (u >= p)
            scale = jnp.where(do_rr & ~kill, 1.0 / p, 1.0)
            thr = vselect(kill, Vec3.zeros(jnp.shape(st.t)), thr * scale)
            done_now = done_now | kill
        state = jnp.where(waiting,
                          jnp.where(done_now, _REGEN, _MARCH), st.state)
        override = (s.hit.x != 0.0) | (s.hit.y != 0.0) | (s.hit.z != 0.0)
        off = jnp.where(new_inside_b, -cfg.inside_offset, cfg.exit_offset)
        o_next = vselect(override, s.hit, hitp + normal * off)
        o = vselect(waiting, o_next, st.o)
        d = vselect(waiting, s.dir, st.d)
        t = jnp.where(waiting, 0.0, st.t)
        steps = jnp.where(waiting, st.gstep if lazy_miss else 0, st.steps)
        st = st._replace(o=o, d=d, t=t, thr=thr, inside=inside,
                         bounce=bounce, state=state, steps=steps)
        st = _reset_relax(st, waiting) if relax else st
        if not nee:
            return st
        # --- stage the shadow segment chain (gen-2 direct-light pattern,
        # `RayMarch2.glsl:480-501` / `integrator._direct_light`): every
        # non-terminated hit detours through light 0's shadow march; the
        # remaining lights' (dir, t_max, contrib) go to the stash.  All
        # draws keyed exactly like the oracle: rng.fork(7).fork(101+li).
        do_nee = waiting & ~term
        nrng = rng.fork(7)
        sh_o_new = hitp + normal * cfg.surface_offset
        per_light = []
        for lix in range(scene.n_lights):
            lrng = nrng.fork(101 + lix)
            lpos, lpower, lradius = scene.light(params, lix)
            jit = uniform_sphere(lrng.next(), lrng.next()) * lradius
            target = lpos + jit
            delta = target - hitp
            dist_l = delta.length()
            ldir = delta / jnp.maximum(dist_l, 1e-8)
            cos_t = jnp.maximum(ldir.dot(normal), 0.0)
            fall = lpower / jnp.maximum(dist_l * dist_l, 1e-8)
            per_light.append((ldir, dist_l,
                              pre_rr_thr * (cos_t * fall / _PI)))
        d0_, tm0, c0 = per_light[0]
        resume = jnp.where(do_nee, st.state, st.resume)
        store = tuple(
            (vselect(do_nee, dL, od), jnp.where(do_nee, tL, otm),
             vselect(do_nee, cL, oc))
            for (dL, tL, cL), (od, otm, oc)
            in zip(per_light[1:], st.sh_store))
        return st._replace(
            state=jnp.where(do_nee, _SHADOW, st.state), resume=resume,
            li=jnp.where(do_nee, 0, st.li),
            sh_o=vselect(do_nee, sh_o_new, st.sh_o),
            sh_d=vselect(do_nee, d0_, st.sh_d),
            seg_tmax=jnp.where(do_nee, tm0, st.seg_tmax),
            contrib=vselect(do_nee, c0, st.contrib), sh_store=store)

    def resolve(st: _MegaState) -> _MegaState:
        """Bank the finished shadow march's contribution and chain to the
        next light, or resume the lane's bounce ray / regeneration."""
        parked = (st.state == _SH_LIT) | (st.state == _SH_OCC)
        lit = st.state == _SH_LIT
        if record_banks:
            # bank the resolved visibility (saturated — ulp-proof against
            # the replay re-deriving dist_l, see kernels/record.py) at the
            # (bounce, sample, light) slot; st.bounce was already
            # incremented by the staging shade pass.
            S = n_paths
            slot = ((st.bounce - 1) * S + st.s_idx) * L + st.li \
                if S > 1 else (st.bounce - 1) * L + st.li
            val = jnp.where(lit, jnp.float32(3.4e38), jnp.float32(0.0))
            st = st._replace(rec=_write_banks(st.rec, bank_refs, (3,),
                                              slot, parked, (val,)))
        extra = Vec3(st.extra.x + jnp.where(lit, st.contrib.x, 0.0),
                     st.extra.y + jnp.where(lit, st.contrib.y, 0.0),
                     st.extra.z + jnp.where(lit, st.contrib.z, 0.0))
        li2 = st.li + 1
        sh_d, seg_tmax, contrib = st.sh_d, st.seg_tmax, st.contrib
        if scene.n_lights > 1:
            more = parked & (li2 < scene.n_lights)
            for k, (dL, tL, cL) in enumerate(st.sh_store):
                sel = more & (li2 == (k + 1))
                sh_d = vselect(sel, dL, sh_d)
                seg_tmax = jnp.where(sel, tL, seg_tmax)
                contrib = vselect(sel, cL, contrib)
        else:
            more = jnp.zeros(jnp.shape(st.t), bool)
        state = jnp.where(parked,
                          jnp.where(more, _SHADOW, st.resume), st.state)
        # lanes leaving the shadow chain march their bounce ray again:
        # restore the uncapped segment
        seg_tmax = jnp.where(parked & ~more, cfg.max_dist, seg_tmax)
        st = st._replace(
            state=state, extra=extra,
            li=jnp.where(parked, jnp.where(more, li2, 0), st.li),
            sh_d=sh_d, seg_tmax=seg_tmax, contrib=contrib,
            t=jnp.where(parked, 0.0, st.t),
            steps=jnp.where(parked, st.gstep if lazy_miss else 0,
                            st.steps))
        return _reset_relax(st, parked) if relax else st

    def regen(st: _MegaState) -> _MegaState:
        """Bank finished paths and respawn the lane on its next sample."""
        pending = st.state == _REGEN
        if defer_sky:
            # parked misses: bank the (throughput, packed equirect (u,v))
            # event at the lane's path slot — the out-of-kernel composite
            # adds thr·sky_uv(u, v) — then respawn WITHOUT banking
            # radiance (the sky part is the composite's; other
            # termination causes bank via `pending` as usual).  (u, v)
            # packs as 16+16 bits of ONE int32 plane (direction would be
            # three): every bank plane is HBM traffic.  atan2 is
            # polynomial (`vecmath.atan2_poly`) and runs once per pass,
            # not per march step.
            from raymarchrenderer.core.vecmath import atan2_poly
            miss_pending = st.state == _WAIT_MISS
            two_pi = jnp.float32(6.283185307179586)
            phi = atan2_poly(st.d.z, st.d.x)
            phi = jnp.where(phi < 0, phi + two_pi, phi)
            uu = phi / two_pi
            vv = 1.0 - (st.d.y * 0.5 + 0.5)
            ui = jnp.clip((uu * 65536.0).astype(jnp.int32), 0, 65535)
            vi = jnp.clip((vv * 65536.0).astype(jnp.int32), 0, 65535)
            uvpack = (ui << 16) | vi
            st = st._replace(rec=_write_banks(
                st.rec, bank_refs, (0, 1, 2, 3), st.s_idx, miss_pending,
                (st.thr.x, st.thr.y, st.thr.z, uvpack)))
            pending_any = pending | miss_pending
        else:
            pending_any = pending
        if nee:
            val = st.thr + st.extra  # oracle: out.color + out.extra
        else:
            val = st.thr
        acc = Vec3(st.acc.x + jnp.where(pending, val.x, 0.0),
                   st.acc.y + jnp.where(pending, val.y, 0.0),
                   st.acc.z + jnp.where(pending, val.z, 0.0))
        if defer_sky and nee:
            # missed paths bank their accumulated NEE radiance here; only
            # the thr·sky term is the composite's (the oracle's defer_sky
            # trace returns color=0 + extra for misses)
            acc = Vec3(acc.x + jnp.where(miss_pending, st.extra.x, 0.0),
                       acc.y + jnp.where(miss_pending, st.extra.y, 0.0),
                       acc.z + jnp.where(miss_pending, st.extra.z, 0.0))
        s_idx = jnp.where(pending_any, st.s_idx + 1, st.s_idx)
        exhausted = s_idx >= n_paths
        state = jnp.where(pending_any,
                          jnp.where(exhausted, _EXH, _MARCH), st.state)
        d_new = primary(s_idx)
        o = vselect(pending_any, eye, st.o)
        d = vselect(pending_any, d_new, st.d)
        thr = vselect(pending_any, lane_channels(s_idx), st.thr)
        t = jnp.where(pending_any, 0.0, st.t)
        steps = jnp.where(pending_any, st.gstep if lazy_miss else 0,
                          st.steps)
        bounce = jnp.where(pending_any, 0, st.bounce)
        inside = jnp.where(pending_any, 0.0, st.inside)
        out = st._replace(o=o, d=d, t=t, thr=thr, acc=acc, inside=inside,
                          bounce=bounce, s_idx=s_idx, state=state,
                          steps=steps)
        if nee:
            out = out._replace(
                extra=Vec3(jnp.where(pending_any, 0.0, st.extra.x),
                           jnp.where(pending_any, 0.0, st.extra.y),
                           jnp.where(pending_any, 0.0, st.extra.z)))
        return _reset_relax(out, pending_any) if relax else out

    def _reset_relax(st: _MegaState, mask) -> _MegaState:
        return st._replace(
            omega=jnp.where(mask, cfg.relax_omega, st.omega),
            prev_r=jnp.where(mask, 0.0, st.prev_r),
            step_len=jnp.where(mask, 0.0, st.step_len))

    def mark_misses(st: _MegaState) -> _MegaState:
        """lazy_miss boundary test: park exhausted segments as misses (and
        apply the miss-time sky multiply the strict step would have)."""
        if nee:
            shadow = st.state == _SHADOW
            seg = (st.state == _MARCH) | shadow
            tmax = st.seg_tmax
        else:
            seg = st.state == _MARCH
            tmax = cfg.max_dist
        is_miss = seg & ((st.t >= tmax)
                         | (st.gstep - st.steps >= cfg.max_steps))
        miss_state = _WAIT_MISS if defer_sky else _REGEN
        if not skip_sky:
            sky = scene.sky(params, st.d)
        if nee:
            bounce_miss = is_miss & ~shadow
            thr = (st.thr if skip_sky
                   else vselect(bounce_miss, st.thr * sky, st.thr))
            state = jnp.where(is_miss,
                              jnp.where(shadow, _SH_LIT, miss_state),
                              st.state)
        else:
            thr = (st.thr if skip_sky
                   else vselect(is_miss, st.thr * sky, st.thr))
            state = jnp.where(is_miss, miss_state, st.state)
        return st._replace(thr=thr, state=state)

    def cheap_pass(st: _MegaState) -> _MegaState:
        """Cadence pass: retire finished paths (and resolve parked shadow
        segments under NEE) WITHOUT the full shade pass's map + normal +
        material ops.  Bitwise — pure scheduling (regen/resolve compute
        the same per-lane values whenever they run)."""
        st = mark_misses(st) if lazy_miss else st
        if nee:
            st = resolve(st)
        return regen(st)

    def parked_pass(st: _MegaState) -> _MegaState:
        if nee:
            # shade stages new shadow segments; resolve banks finished
            # ones (possibly un-parking lanes straight into regen below)
            return regen(resolve(shade(st)))
        return regen(shade(st))

    def body(st: _MegaState) -> _MegaState:
        if regen_cadence and regen_cadence < march_unroll:
            n_sub = march_unroll // regen_cadence
            for c in range(n_sub):
                for _ in range(regen_cadence):
                    st = march_step(st)
                if c < n_sub - 1:
                    st = cheap_pass(st)
        else:
            for _ in range(march_unroll):
                st = march_step(st)
        if lazy_miss:
            st = mark_misses(st)
        if shade_gate <= 0:
            # unconditional cadence: one (masked) pass per chunk — no global
            # reductions, no cond.  Right when segments are short (relaxed
            # march) and the chunk is small.
            return parked_pass(st)
        n_march = jnp.sum(((st.state == _MARCH)
                           | (st.state == _SHADOW)).astype(jnp.int32))
        n_park = jnp.sum(((st.state == _WAIT) | (st.state == _REGEN)
                          | (st.state == _WAIT_MISS)
                          | (st.state == _SH_LIT)
                          | (st.state == _SH_OCC)).astype(jnp.int32))
        # Batch the expensive pass over many parked lanes, but never let the
        # tile stall with everyone parked (n_march == 0 always fires).
        do_pass = (n_park > 0) & (
            n_park.astype(jnp.float32) * jnp.float32(shade_gate)
            >= n_march.astype(jnp.float32))
        return lax.cond(do_pass, parked_pass, lambda s: s, st)

    def cond(st: _MegaState):
        return jnp.min(st.state) < _EXH

    zero = jnp.zeros(shape, jnp.float32)
    izero = jnp.zeros(shape, jnp.int32)
    init = _MegaState(
        o=eye, d=primary(izero), t=zero, thr=lane_channels(izero),
        acc=Vec3.zeros(shape),
        inside=zero, bounce=izero, s_idx=izero, state=izero, steps=izero,
        gstep=jnp.int32(0) if lazy_miss else None,
        omega=jnp.full(shape, max(cfg.relax_omega, 1.0), jnp.float32),
        prev_r=zero, step_len=zero)
    if nee:
        init = init._replace(
            sh_o=Vec3.zeros(shape), sh_d=Vec3.zeros(shape),
            seg_tmax=jnp.full(shape, cfg.max_dist, jnp.float32),
            contrib=Vec3.zeros(shape), extra=Vec3.zeros(shape),
            resume=izero, li=izero,
            sh_store=tuple((Vec3.zeros(shape), zero, Vec3.zeros(shape))
                           for _ in range(scene.n_lights - 1)))
    if record_banks:
        # defaults = the oracle march's missed/inactive-lane returns
        BS = B * n_paths
        specs = ((BS, cfg.max_dist, jnp.float32), (BS, -1, jnp.int32),
                 (BS, 0, jnp.int32))
        if L:
            specs += ((BS * L, 3.4e38, jnp.float32),)
        init = init._replace(rec=_init_banks(specs, shape, bank_refs))
    if defer_sky:
        # (thr.xyz f32, packed-uv i32) miss-event banks, one slot per
        # path; thr=0 marks a dead slot (path ended on a hit/emitter)
        specs = ((n_paths, 0.0, jnp.float32),) * 3 + ((n_paths, 0,
                                                        jnp.int32),)
        init = init._replace(rec=_init_banks(specs, shape, bank_refs))
    st0 = march_step(init)
    out = lax.while_loop(cond, body, st0)
    if record_banks or defer_sky:
        return out.acc, out.rec
    return out.acc


def trace_mega(scene: Scene, params, cfg: RenderConfig, corners,
               px, py, sample, channels: Vec3,
               shade_gate: float = 1.0, march_unroll: int = 1,
               direct_light: bool = False) -> Vec3:
    """Single-sample megakernel trace: bitwise equal to `trace_rgb` (the
    primary ray is regenerated internally from the same RNG stream)."""
    return trace_mega_paths(scene, params, cfg, corners, px, py, sample,
                            channels, n_samples=1, shade_gate=shade_gate,
                            march_unroll=march_unroll,
                            direct_light=direct_light)


class _SpecState(NamedTuple):
    """Megakernel lane state for the gen-3 spectral transport
    (`RayMarch3.glsl:347-444`): per-path wavelength + scalar power instead
    of RGB throughput.  Parked hits are `_WAIT`, parked misses
    `_WAIT_MISS` (the sky is an emitter band, so misses also go through
    the shade pass — same RNG slots as the oracle); encoding the event in
    the state saves a dedicated hit/miss carry."""
    o: Vec3
    d: Vec3
    t: jax.Array
    wl: jax.Array      # wavelength (nm; 0 == unset)
    power: jax.Array   # scalar path power
    acc: Vec3          # banked RGB splat sum over finished samples
    bounce: jax.Array
    s_idx: jax.Array
    state: jax.Array
    # strict schedule: per-lane step COUNT (+1 every march step).
    # lazy_miss schedule: per-lane step counter value at SEGMENT START
    # (written only in passes); the live count is `gstep - steps`.  All
    # segment starts happen at pass boundaries, so the count read by
    # mark_misses is identical — but the hot loop drops its per-lane
    # vector increment (the only consumer is the boundary test) and the
    # plane stops being written every step (less VREG churn).
    steps: jax.Array
    omega: jax.Array
    prev_r: jax.Array
    step_len: jax.Array
    # scalar global march-step counter (lazy_miss only; scalar add ≈ free)
    gstep: jax.Array = None
    # record-mode banks (record_banks=True): STACKED (B·S, h, w) carries
    # (t f32, mid i32, hit i32) — the march residuals the differentiable
    # spectral replay consumes (trace_spectral(march_impl='recorded'))
    rec: tuple = ()
    # occupancy counters (None unless with_occupancy): per-lane counts of
    # march_step calls spent MARCHING vs total
    m_cnt: jax.Array = None
    tot_cnt: jax.Array = None


def trace_mega_spectral(scene: Scene, params, mats, cfg: RenderConfig,
                        corners, px, py, sample0, n_samples: int = 1,
                        shade_gate: float = 0.0,
                        march_unroll: int = 1,
                        with_occupancy: bool = False,
                        lazy_miss: bool = False,
                        regen_cadence: int = 0,
                        record_banks: bool = False,
                        bank_refs=None):
    """Spectral twin of `trace_mega_paths`: sum over `n_samples` of
    `wavelengthToColor(λ)·power` per pixel, bitwise equal to
    Σ_s render_sample_spectral(sample0+s) (same RNG slots per
    (pixel, sample, bounce)).  Forward only.

    `with_occupancy=True` additionally returns (marching_steps, total
    steps) per-lane counters: every `march_step` increments `total` for
    every lane and `marching` only where the lane is in `_MARCH` — their
    ratio is the tile's masked-lane occupancy (the divergence bound of
    the megakernel schedule; `utils.metrics.mega_occupancy_profile`).

    Per-step op-count knobs (every op in the march step runs once per
    lane per step, so per-step ops are the currency):

    `lazy_miss=True` moves the 6-op per-step miss test (t ≥ max_dist |
    steps ≥ max_steps, plus its state select) OUT of the march step to
    the pass boundary.  Legal because (1) a parked lane burns the map
    eval anyway — SIMD — so overshoot steps cost nothing extra, (2) a
    missed path's t/steps are never read by the shade (the sky band
    depends only on the RNG slot), and (3) segments start at pass
    boundaries, so the steps budget is tested at the same counts.  NOT
    bitwise in full generality: a lane that crosses the max_dist shell
    mid-chunk keeps marching to the boundary and can (rarely, grazing
    geometry AT the shell) hit where the strict march declared the miss
    first — the relax_omega/normal_taps class of O(rare-lane) trade
    (converged-equal; bitwise on scenes whose geometry is well inside
    max_dist, asserted in tests/test_mega.py).

    `regen_cadence=k` (0 = off) additionally runs a CHEAP pass every k
    march steps (k divides march_unroll) that retires ONLY parked misses
    — sky band + splat + respawn, no map/normal — so miss-terminated
    lanes re-enter the march up to unroll/k× sooner without paying the
    full shade pass's ops at that cadence.  Pure scheduling: the RNG
    slots drawn are identical, so it IS bitwise (each lane's path
    sequence is unchanged, only the wall-clock step at which it respawns
    moves)."""
    from raymarchrenderer.core.spectral import wavelength_to_rgb
    from raymarchrenderer.render.spectral_integrator import (
        _apply_band, _lookup)

    shape = jnp.shape(px)
    e = eye_vec(corners)
    eye = Vec3(jnp.broadcast_to(e.x, shape).astype(jnp.float32),
               jnp.broadcast_to(e.y, shape).astype(jnp.float32),
               jnp.broadcast_to(e.z, shape).astype(jnp.float32))
    s0 = jnp.asarray(sample0).astype(jnp.uint32)
    sky_min, sky_max, sky_p = 390.0, 830.0, jnp.float32(cfg.sky_power)
    relax = cfg.relax_omega > 1.0
    _one_minus_omega = float(np.float32(1.0) - np.float32(cfg.relax_omega))
    if record_banks and with_occupancy:
        # regen_cadence AND lazy_miss compose with recording (see the
        # trace_mega_paths note); the occupancy counters stay render-only
        raise ValueError("record_banks keeps the strict miss schedule "
                         "(occupancy is a render-only knob)")
    if (regen_cadence and regen_cadence < march_unroll
            and march_unroll % regen_cadence):
        # cadence >= unroll simply means "no mid-chunk pass" (body() only
        # splits when regen_cadence < march_unroll), so a caller overriding
        # the unroll below the default cadence is fine
        raise ValueError("regen_cadence must divide march_unroll")

    def primary(s_idx):
        s = s0 + s_idx.astype(jnp.uint32)
        rng = RNGStream(cfg.seed, px, py, s, jnp.uint32(1 << 20))
        return primary_rays(corners, px, py, cfg.width, cfg.height, rng)

    def march_step(st: _SpecState) -> _SpecState:
        marching = st.state == _MARCH
        if with_occupancy:
            st = st._replace(m_cnt=st.m_cnt + marching.astype(jnp.int32),
                             tot_cnt=st.tot_cnt + 1)
        p = st.o + st.d * st.t
        dist = scene.map_dist(params, p, cfg.max_dist)
        if relax:
            fail = marching & (st.omega > 1.0) & (
                dist + st.prev_r < st.step_len)
        else:
            fail = jnp.zeros(shape, bool)
        is_hit = marching & ~fail & (dist < cfg.hit_eps)
        if lazy_miss:
            # miss detection deferred to `mark_misses` at the pass
            # boundary — the hot loop carries only the hit test.  The
            # step budget is tracked by the SCALAR gstep counter (+1 per
            # step, ~free) against the per-lane segment-start snapshot in
            # st.steps: one vector add per step removed, and the steps
            # plane is no longer written in the loop (see _SpecState)
            upd = dict(gstep=st.gstep + 1)
            state = jnp.where(is_hit, _WAIT, st.state)
            still = marching & ~is_hit
        else:
            # unconditional: only marching lanes' counts are read
            # (is_miss is masked by `marching`), and every MARCH
            # transition resets to 0, so dropping the select is exact
            steps = st.steps + 1
            upd = dict(steps=steps)
            is_miss = marching & ~fail & ~is_hit & (
                (st.t >= cfg.max_dist) | (steps >= cfg.max_steps))
            # both hit AND miss park for the shade pass: the sky is an
            # emitter band filter drawing the same RNG slot as a surface
            state = jnp.where(is_hit, _WAIT,
                              jnp.where(is_miss, _WAIT_MISS, st.state))
            still = marching & ~is_hit & ~is_miss
        if relax:
            # (1 - omega) const-folded: see the lazy branch note
            new_len = jnp.where(fail, st.step_len * _one_minus_omega,
                                dist * st.omega)
            omega = jnp.where(fail, 1.0, st.omega)
            prev_r = jnp.where(still, jnp.abs(dist), st.prev_r)
            step_len = jnp.where(still, jnp.abs(new_len), st.step_len)
            t = jnp.where(still, st.t + new_len, st.t)
            return st._replace(t=t, state=state, omega=omega,
                               prev_r=prev_r, step_len=step_len, **upd)
        t = jnp.where(still, st.t + dist * cfg.step_multiply, st.t)
        return st._replace(t=t, state=state, **upd)

    def mark_misses(st: _SpecState) -> _SpecState:
        """lazy_miss boundary test: park exhausted marchers as misses.

        st.steps holds the gstep snapshot at segment start (lazy mode),
        so gstep - steps is the lane's live step count — identical to the
        strict counter since all segment starts are at pass boundaries."""
        is_miss = (st.state == _MARCH) & (
            (st.t >= cfg.max_dist)
            | (st.gstep - st.steps >= cfg.max_steps))
        return st._replace(state=jnp.where(is_miss, _WAIT_MISS, st.state))

    def shade(st: _SpecState) -> _SpecState:
        waiting = (st.state == _WAIT) | (st.state == _WAIT_MISS)
        hit_b = st.state == _WAIT
        hitp = st.o + st.d * st.t
        _, mid = scene.map(params, hitp, cfg.max_dist)
        normal = get_normal(scene, params, cfg, hitp)
        s_id = s0 + st.s_idx.astype(jnp.uint32)
        rng = RNGStream(cfg.seed, px, py, s_id, st.bounce)
        u = rng.next()
        m_min, m_max, m_pow, m_kind = _lookup(mats, mid)
        if record_banks:
            # bank this hit's march residuals at the lane's
            # (bounce, sample) slot — slot = b·S + s (misses keep the
            # init values t=max_dist/mid=-1/hit=0, exactly the oracle
            # march's miss return).  Stacked one-hot broadcast write,
            # same pattern as the RGB recorder's.
            S = n_samples
            slot = st.bounce * S + st.s_idx if S > 1 else st.bounce
            st = st._replace(rec=_write_banks(
                st.rec, bank_refs, (0, 1, 2), slot, hit_b,
                (st.t, mid, jnp.ones(shape, jnp.int32))))
        # ONE _apply_band over hit_b-selected band params instead of two
        # (hit + sky) calls: _apply_band is elementwise in its params, so
        # selecting inputs ≡ selecting outputs bitwise — and the pass pays
        # one band evaluation (incl. its divide) instead of two
        b_min = jnp.where(hit_b, m_min, sky_min)
        b_max = jnp.where(hit_b, m_max, sky_max)
        b_pow = jnp.where(hit_b, m_pow, sky_p)
        wl_n, pw_n, absorbed = _apply_band(st.wl, st.power, u,
                                           b_min, b_max, b_pow)
        wl = jnp.where(waiting, wl_n, st.wl)
        power = jnp.where(waiting, pw_n, st.power)
        if record_banks:
            # SOFT-replay termination: the differentiable band filter
            # (_apply_band_soft) never absorbs — it attenuates — so the
            # recorded segment set must continue through absorptions for
            # the replay to find its bounces banked
            term = (hit_b & (m_kind == 1)) | ~hit_b
        else:
            term = (hit_b & ((m_kind == 1) | absorbed)) | ~hit_b
        bounce = jnp.where(waiting, st.bounce + 1, st.bounce)
        done_now = term | (bounce >= cfg.max_bounces)
        state = jnp.where(waiting,
                          jnp.where(done_now, _REGEN, _MARCH), st.state)
        new_dir = uniform_sphere_or_hemisphere(rng.next(), rng.next(),
                                               normal)
        o = vselect(waiting, hitp + normal * cfg.surface_offset, st.o)
        d = vselect(waiting, new_dir, st.d)
        t = jnp.where(waiting, 0.0, st.t)
        # lazy mode: steps stores the segment-start gstep snapshot
        seg0 = st.gstep if lazy_miss else 0
        steps = jnp.where(waiting, seg0, st.steps)
        st = st._replace(o=o, d=d, t=t, wl=wl, power=power, bounce=bounce,
                         state=state, steps=steps)
        return _reset_relax_spec(st, waiting) if relax else st

    def regen(st: _SpecState) -> _SpecState:
        pending = st.state == _REGEN
        c = wavelength_to_rgb(st.wl) * st.power
        acc = Vec3(st.acc.x + jnp.where(pending, c.x, 0.0),
                   st.acc.y + jnp.where(pending, c.y, 0.0),
                   st.acc.z + jnp.where(pending, c.z, 0.0))
        s_idx = jnp.where(pending, st.s_idx + 1, st.s_idx)
        exhausted = s_idx >= n_samples
        state = jnp.where(pending,
                          jnp.where(exhausted, _EXH, _MARCH), st.state)
        d_new = primary(s_idx)
        o = vselect(pending, eye, st.o)
        d = vselect(pending, d_new, st.d)
        wl = jnp.where(pending, 0.0, st.wl)
        power = jnp.where(pending, 1.0, st.power)
        t = jnp.where(pending, 0.0, st.t)
        seg0 = st.gstep if lazy_miss else 0
        steps = jnp.where(pending, seg0, st.steps)
        bounce = jnp.where(pending, 0, st.bounce)
        st = st._replace(o=o, d=d, t=t, wl=wl, power=power, acc=acc,
                         bounce=bounce, s_idx=s_idx, state=state,
                         steps=steps)
        return _reset_relax_spec(st, pending) if relax else st

    def _reset_relax_spec(st: _SpecState, mask) -> _SpecState:
        return st._replace(
            omega=jnp.where(mask, cfg.relax_omega, st.omega),
            prev_r=jnp.where(mask, 0.0, st.prev_r),
            step_len=jnp.where(mask, 0.0, st.step_len))

    def miss_pass(st: _SpecState) -> _SpecState:
        """Cheap cadence pass: retire ONLY parked misses — sky band +
        splat + respawn, no map eval, no normals.  Draws the same RNG
        slot `shade` would (the stream is counter-based, so not drawing
        the unused direction slots changes nothing), so path sequences
        are bitwise-identical to the full-pass-only schedule."""
        missing = st.state == _WAIT_MISS
        s_id = s0 + st.s_idx.astype(jnp.uint32)
        rng = RNGStream(cfg.seed, px, py, s_id, st.bounce)
        u = rng.next()
        wl_s, pw_s, _ = _apply_band(st.wl, st.power, u,
                                    sky_min, sky_max, sky_p)
        st = st._replace(
            wl=jnp.where(missing, wl_s, st.wl),
            power=jnp.where(missing, pw_s, st.power),
            bounce=jnp.where(missing, st.bounce + 1, st.bounce),
            state=jnp.where(missing, _REGEN, st.state))
        return regen(st)

    def parked_pass(st: _SpecState) -> _SpecState:
        return regen(shade(st))

    def body(st: _SpecState) -> _SpecState:
        if regen_cadence and regen_cadence < march_unroll:
            n_sub = march_unroll // regen_cadence
            for c in range(n_sub):
                for _ in range(regen_cadence):
                    st = march_step(st)
                if c < n_sub - 1:
                    st = miss_pass(mark_misses(st) if lazy_miss else st)
        else:
            for _ in range(march_unroll):
                st = march_step(st)
        if lazy_miss:
            st = mark_misses(st)
        if shade_gate <= 0:
            return parked_pass(st)
        n_march = jnp.sum((st.state == _MARCH).astype(jnp.int32))
        n_park = jnp.sum(((st.state == _WAIT)
                          | (st.state == _REGEN)
                          | (st.state == _WAIT_MISS)).astype(jnp.int32))
        do_pass = (n_park > 0) & (
            n_park.astype(jnp.float32) * jnp.float32(shade_gate)
            >= n_march.astype(jnp.float32))
        return lax.cond(do_pass, parked_pass, lambda s: s, st)

    def cond(st: _SpecState):
        return jnp.min(st.state) < _EXH

    zero = jnp.zeros(shape, jnp.float32)
    izero = jnp.zeros(shape, jnp.int32)
    init = _SpecState(
        o=eye, d=primary(izero), t=zero, wl=zero,
        power=jnp.ones(shape, jnp.float32), acc=Vec3.zeros(shape),
        bounce=izero, s_idx=izero, state=izero, steps=izero,
        omega=jnp.full(shape, max(cfg.relax_omega, 1.0), jnp.float32),
        prev_r=zero, step_len=zero,
        gstep=jnp.int32(0) if lazy_miss else None)
    if with_occupancy:
        init = init._replace(m_cnt=izero, tot_cnt=izero)
    if record_banks:
        BS = cfg.max_bounces * n_samples
        init = init._replace(rec=_init_banks(
            ((BS, cfg.max_dist, jnp.float32), (BS, -1, jnp.int32),
             (BS, 0, jnp.int32)), shape, bank_refs))
    st0 = march_step(init)
    out = lax.while_loop(cond, body, st0)
    if with_occupancy:
        return out.acc, out.m_cnt, out.tot_cnt
    if record_banks:
        return out.acc, out.rec
    return out.acc
