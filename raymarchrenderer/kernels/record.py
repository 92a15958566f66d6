"""Recording trace kernel: the megakernel-rate differentiable forward.

Runs the ENTIRE forward trace of a train step in ONE Pallas launch — the
same megakernel schedule as the production render kernel
(`render.mega.trace_mega_paths(record_banks=True)`: per-lane bounce
progression, in-loop sample regeneration, shadow marches as extra
segments, per-block early-out) — and stores exactly the planes the
differentiable replay needs, which are exactly the residuals
`diff.march.march_save_policy()` already saves:

    t[b], mat_id[b], hit[b]          per bounce        ("march_t" ...)
    shadow_t[b, li]                  per bounce, light ("shadow_t")

Each record is one masked store into its (slot, y, x) address of the
output; nothing is carried through the loop.

The XLA side (`render.integrator.trace_rgb(march_impl="recorded")`) then
replays the cheap shade chain over the recorded geometry, attaching
gradients with the SAME reparameterized / implicit-function adjoint as the
per-bounce path (`diff.march.reparam_t`) — so the march (the cost center
of both passes, `RayMarch3.glsl:145-169`) runs once, in the kernel, at
kernel rates, and reverse-mode never sees a while_loop.

Parity note: the in-kernel shade chain is the same traced code as the XLA
replay, but Triton and XLA may contract FMAs differently, so recorded
bounce-(b>0) geometry can differ from the plain trace at ulp level on
lanes whose shade math contracts; gradients agree to float32 tolerance
(tested), bitwise on scenes where no contraction divergence occurs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from raymarchrenderer.core.vecmath import Vec3
from raymarchrenderer.kernels.march import (DEFAULT_BH, DEFAULT_BW, BankRefs,
                                            DEFAULT_LAZY_MISS,
                                            DEFAULT_MARCH_UNROLL,
                                            DEFAULT_REGEN_CADENCE,
                                            _block_pixels, _corner_tuple,
                                            _launch_rows, _no_env_image,
                                            launch_block, pallas_launch)
from raymarchrenderer.kernels.ship import unpack
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.scene.graph import Scene


def _schedule(interpret: bool):
    """(march_unroll, regen_cadence): the render kernel's schedule; the
    interpreter keeps one step per chunk (pure scheduling, bitwise)."""
    if interpret:
        return 1, 0
    return DEFAULT_MARCH_UNROLL, DEFAULT_REGEN_CADENCE


def _record_launch(kernel, rows, bh, bw, hp, wp, banks, interpret):
    """Launch a recorder: `banks` = ((depth, dtype), ...) outputs of shape
    (depth, hp, wp), each block owning its (depth, bh, bw) window."""
    out_specs = tuple(pl.BlockSpec((k, bh, bw), lambda i, j: (0, i, j))
                      for k, _ in banks)
    out_shape = tuple(jax.ShapeDtypeStruct((k, hp, wp), dt)
                      for k, dt in banks)
    return pallas_launch(kernel, rows, (hp // bh, wp // bw), out_specs,
                         out_shape, interpret)


def trace_record_fused(scene: Scene, params, cfg: RenderConfig, corners,
                       origin_xy, patch_shape, sample0,
                       direct_light: bool = False,
                       block=(DEFAULT_BH, DEFAULT_BW),
                       interpret: bool = False,
                       n_samples: int = 1,
                       lazy_miss: bool = DEFAULT_LAZY_MISS):
    """Run the full `trace_rgb` forward of every pixel of a (ph, pw) patch
    at `origin_xy`, for samples [sample0, sample0 + n_samples), in ONE
    Pallas launch and return the recorded march planes in the replay's
    sample-folded layout (S = n_samples, B = cfg.max_bounces):

        {"t": (B, S·H, W) f32, "mid": (B, S·H, W) i32,
         "hit": (B, S·H, W) i32, "sd": (B·L, S·H, W) f32}  # sd: NEE only

    Under dispersion each key gains a leading channel axis of 3.
    Everything is detached — gradients come from the replay
    (`trace_rgb(march_impl="recorded", recorded=...)`).

    `lazy_miss` (default: the render kernel's, so the recorded forward
    runs the SAME estimator schedule as the production render) applies
    the boundary-deferred miss test: banks are bitwise-identical on scenes
    whose geometry sits well inside max_dist (tested; the same rare-lane
    shell-grazing caveat as the render).  NEE recording stays STRICT
    regardless — lazy flips ~1e-5 of shadow-visibility verdicts (a
    discrete estimator change)."""
    from raymarchrenderer.render.mega import trace_mega_paths

    if scene.has_env_map:
        # the recorder traces GEOMETRY only (t, mid, hit[, sd]): the color
        # output is discarded and a missed path terminates, so no recorded
        # value depends on the sky — the equirect gather stays in the XLA
        # replay, which computes it differentiably
        params = _no_env_image(params)
    params = lax.stop_gradient(params)
    h, w = patch_shape
    B = cfg.max_bounces
    S = int(n_samples)
    disp = bool(cfg.separate_channels)
    P = 3 * S if disp else S  # banked path slots per bounce
    nee = direct_light and scene.n_lights > 0
    L = scene.n_lights if nee else 0
    bh, bw, hp, wp = launch_block(block, (h, w))
    march_unroll, cadence = _schedule(interpret)
    rows, layout = _launch_rows(
        {"params": params,
         "corners": jnp.stack([jnp.asarray(c, jnp.float32)
                               for c in corners])},
        sample0, origin_xy)

    def kernel(f_ref, i_ref, *bank_refs):
        t = unpack(layout, f_ref, i_ref)
        px, py = _block_pixels(t, bh, bw)
        trace_mega_paths(scene, t["params"], cfg,
                         _corner_tuple(t["corners"]), px, py, t["sample"],
                         Vec3.full((bh, bw), 1.0, 1.0, 1.0), n_samples=S,
                         shade_gate=0.0, march_unroll=march_unroll,
                         regen_cadence=cadence, dispersion=disp,
                         direct_light=direct_light, record_banks=True,
                         # NEE stays strict (see docstring)
                         lazy_miss=lazy_miss and not nee and not interpret,
                         bank_refs=BankRefs(bank_refs))

    BS = B * P
    banks = [(BS, jnp.float32), (BS, jnp.int32), (BS, jnp.int32)]
    if nee:
        banks.append((BS * L, jnp.float32))
    outs = _record_launch(kernel, rows, bh, bw, hp, wp, banks, interpret)
    outs = [a[:, :h, :w] for a in outs]

    if disp:
        # slot b·3S + (3s + ci): fold to per-CHANNEL sample-folded banks
        # (3, B, S·H, W) — the replay's channel loop slices [ci] and gets
        # exactly the RGB recorded layout
        def fold(a):
            return a.reshape(B, S, 3, h, w).transpose(2, 0, 1, 3, 4) \
                    .reshape(3, B, S * h, w)

        rec = {"t": fold(outs[0]), "mid": fold(outs[1]),
               "hit": fold(outs[2])}
        if nee:
            sd = outs[3].reshape(B, S, 3, L, h, w)
            rec["sd"] = sd.transpose(2, 0, 3, 1, 4, 5) \
                          .reshape(3, B * L, S * h, w)
        return rec

    def fold(a):
        # slot b·S+s → the replay's sample-folded (B, S·H, W) layout
        return a.reshape(B, S * h, w)

    rec = {"t": fold(outs[0]), "mid": fold(outs[1]), "hit": fold(outs[2])}
    if nee:
        # slot (b·S+s)·L+li → (B·L, S·H, W) with replay index b·L+li
        sd = outs[3].reshape(B, S, L, h, w)
        rec["sd"] = sd.transpose(0, 2, 1, 3, 4).reshape(B * L, S * h, w)
    return rec


def trace_record_fused_spectral(scene: Scene, params, mats,
                                cfg: RenderConfig, corners, origin_xy,
                                patch_shape, sample0, n_samples: int = 1,
                                block=(DEFAULT_BH, DEFAULT_BW),
                                interpret: bool = False,
                                lazy_miss: bool = DEFAULT_LAZY_MISS):
    """Spectral recorder: the gen-3 megakernel schedule traces every
    (sample, bounce) march in ONE Pallas launch and stores the
    (t, mid, hit) residuals the differentiable spectral replay consumes
    (`spectral_integrator.trace_spectral(march_impl='recorded')`).

    Geometry is band-VALUE independent: gen-3 directions are
    uniform-hemisphere draws and the recorder terminates only on emitter
    hits / misses (the soft replay's rule — `_apply_band_soft` attenuates
    instead of absorbing), so one recording serves every band-table
    update of a train step.  Returns {"t","mid","hit"} in the replay's
    sample-folded (B, S·H, W) layout."""
    from raymarchrenderer.render.mega import trace_mega_spectral

    params = lax.stop_gradient(_no_env_image(params))
    mats = lax.stop_gradient(mats)
    h, w = patch_shape
    B = cfg.max_bounces
    S = int(n_samples)
    bh, bw, hp, wp = launch_block(block, (h, w))
    march_unroll, cadence = _schedule(interpret)
    rows, layout = _launch_rows(
        {"params": params, "mats": mats,
         "corners": jnp.stack([jnp.asarray(c, jnp.float32)
                               for c in corners])},
        sample0, origin_xy)

    def kernel(f_ref, i_ref, *bank_refs):
        t = unpack(layout, f_ref, i_ref)
        px, py = _block_pixels(t, bh, bw)
        trace_mega_spectral(scene, t["params"], t["mats"], cfg,
                            _corner_tuple(t["corners"]), px, py,
                            t["sample"], n_samples=S, shade_gate=0.0,
                            march_unroll=march_unroll,
                            regen_cadence=cadence, record_banks=True,
                            lazy_miss=lazy_miss and not interpret,
                            bank_refs=BankRefs(bank_refs))

    BS = B * S
    outs = _record_launch(kernel, rows, bh, bw, hp, wp,
                          [(BS, jnp.float32), (BS, jnp.int32),
                           (BS, jnp.int32)], interpret)
    t_, mid, hit = (a[:, :h, :w].reshape(B, S * h, w) for a in outs)
    return {"t": t_, "mid": mid, "hit": hit}
