"""Differentiable sphere tracing: the reparameterized / detached-march adjoint.

Naive reverse-mode through the march loop is impossible (`lax.while_loop`
has no transpose) and a fixed-length unroll would checkpoint ≤512 iterates of
the whole pixel batch — hostile to HBM.  Instead we differentiate the march
*implicitly*: the converged hit distance t*(θ, o, d) satisfies

    f(o + t* d; θ) = 0            (f = scene SDF, θ = scene parameters)

so by the implicit function theorem

    dt*/dθ = -f_θ / (∇f·d),  dt*/do = -∇f / (∇f·d),  dt*/dd = -t* ∇f / (∇f·d)

evaluated at the (detached) hit point.  Missed rays get zero gradient (their
t is clamped to max_dist — a constant).

Implementation note (why a surrogate instead of `jax.custom_vjp`): the
gradient is attached by the standard zero-valued reparameterization

    t_out = t_detached - (f(o + d·t_detached; θ) - sg(f)) / sg(∇f·d)

whose value is exactly t_detached (the residual term is identically zero)
and whose derivatives are the IFT formulas above.  Expressed this way the
march itself is a *fully detached* primal computation whose outputs are
tagged with `checkpoint_name`, so a `jax.checkpoint` over the render with
policy `save_only_these_names("march_t", ...)` stores the three cheap
(t, mid, hit) planes and the backward replay DCEs the entire march loop —
the cost center of both passes (`RayMarch3.glsl:145-169`) runs ONCE per
train step instead of twice.  A `custom_vjp` boundary cannot be split by
partial evaluation, so the earlier custom_vjp formulation forced the remat
replay to re-run the march just to rebuild its residuals.

This is the "detached march / reparameterized hit point" adjoint called for
by the north star (BASELINE.json) and SURVEY.md §7 hard-part (b).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.ad_checkpoint import checkpoint_name

from raymarchrenderer.core.vecmath import Vec3


def reparam_t(scene, cfg, params, o: Vec3, d: Vec3, t, valid):
    """Attach implicit-function gradients to a detached hit distance.

    `t` is treated as a constant (it is stop_gradient'ed internally); the
    returned value equals `t` bitwise but carries

        dt/dθ = -f_θ/(∇f·d),  dt/do = -∇f/(∇f·d),  dt/dd = -t·∇f/(∇f·d)

    wherever `valid` and the denominator is well-conditioned, and exactly
    zero gradient elsewhere.  Costs ~3 extra map evaluations per lane in
    the forward graph (one primal + one VJP sweep for the detached ∇f)."""
    t_sg = lax.stop_gradient(t)
    o_sg = Vec3(*(lax.stop_gradient(c) for c in (o.x, o.y, o.z)))
    d_sg = Vec3(*(lax.stop_gradient(c) for c in (d.x, d.y, d.z)))

    # detached surface gradient ∇f at the hit point → the IFT denominator
    def fp(px, py, pz):
        return scene.map_dist(lax.stop_gradient(params), Vec3(px, py, pz),
                              cfg.max_dist)

    p_sg = o_sg + d_sg * t_sg
    _, vjp_p = jax.vjp(fp, p_sg.x, p_sg.y, p_sg.z)
    gx, gy, gz = vjp_p(jnp.ones_like(t_sg))
    denom = gx * d_sg.x + gy * d_sg.y + gz * d_sg.z
    safe = valid & (jnp.abs(denom) > 1e-6)
    inv = jnp.where(safe, 1.0 / jnp.where(safe, denom, 1.0), 0.0)
    inv = lax.stop_gradient(inv)

    # differentiable SDF residual at the detached hit point: value 0,
    # derivatives (f_θ, ∇f, t·∇f) w.r.t. (params, o, d) via p = o + d·t_sg
    g = scene.map_dist(params, o + d * t_sg, cfg.max_dist)
    return t_sg - (g - lax.stop_gradient(g)) * inv


def _name_march(t, mid, hitm):
    """Tag the detached march outputs as remat-saveable residuals (see the
    module docstring): `jax.checkpoint_policies.save_only_these_names(
    "march_t", "march_mid", "march_hit")` keeps these three planes and the
    backward replay never re-runs the march loop / Pallas kernel."""
    return (checkpoint_name(t, "march_t"),
            checkpoint_name(mid, "march_mid"),
            checkpoint_name(hitm, "march_hit"))


# The residual names saved by the march-skipping remat policy
# (`parallel.sharding.train_step_sharded(remat=True)` uses this).
MARCH_SAVE_NAMES = ("march_t", "march_mid", "march_hit", "shadow_t")


def march_save_policy():
    """Remat policy for differentiable renders: save the (t, mid, hit)
    planes of every march (and NEE shadow visibility) so the backward
    replay recomputes only the cheap shading chain, never the march."""
    return jax.checkpoint_policies.save_only_these_names(*MARCH_SAVE_NAMES)


def march_diff(scene, cfg, params, o: Vec3, d: Vec3, dist_mult, active):
    """Drop-in replacement for `render.integrator.march` with gradients.

    Returns (t, mat_index, hit_mask); t carries implicit-function gradients
    w.r.t. params / ray origin / ray direction."""
    from raymarchrenderer.render.integrator import march
    t, mid, hitm = march(scene, lax.stop_gradient(params), cfg,
                         Vec3(*(lax.stop_gradient(c)
                                for c in (o.x, o.y, o.z))),
                         Vec3(*(lax.stop_gradient(c)
                                for c in (d.x, d.y, d.z))),
                         lax.stop_gradient(dist_mult), active)
    t, mid, hitm = _name_march(t, mid, hitm)
    t = reparam_t(scene, cfg, params, o, d, t, hitm & active)
    return t, mid, hitm


def march_diff_recorded(scene, cfg, params, o: Vec3, d: Vec3, active,
                        rec_t, rec_mid, rec_hit):
    """The recorded-forward variant (`kernels.record.trace_record_fused`):
    the march already ran inside the ONE-launch recording kernel; this just
    tags its banked (t, mid, hit) planes as remat residuals and attaches
    the shared implicit-function adjoint.  Zero marches in the XLA graph —
    forward or backward."""
    hitm = rec_hit > 0
    t, mid, hitm = _name_march(rec_t, rec_mid, hitm)
    t = reparam_t(scene, cfg, params, o, d, t, hitm & active)
    return t, mid, hitm
