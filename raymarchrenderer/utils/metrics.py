"""Render metrics / observability.

The reference's only runtime telemetry is `std::cout`: the per-sample
counter (`Program.cpp:201`) and the wall render time
(`Program.cpp:192,245,296`).  This stack upgrades it to (SURVEY.md §5):

  * `instrumented_sample` — one forward sample that ALSO returns the
    per-pixel march work profile: steps used on the primary segment, path
    bounce depth, and hit/miss — the data behind a steps-per-ray histogram
    and the rays/s accounting (everything derived device-side in the same
    jitted program; no host round-trips per pixel),
  * `RenderStats` — the aggregated snapshot (histograms + totals),
  * `MetricsLogger` — structured JSONL logging with wall-clock timing,
    replacing the cout stream.

The instrumentation reuses the oracle `march`/`trace_rgb` path unchanged —
it wraps, never forks, the production integrator (the profile march is ONE
extra march of the primary segment; its cost is ~1/avg_bounces of the
sample and only paid when metrics are requested).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from raymarchrenderer.core.rng import RNGStream
from raymarchrenderer.core.vecmath import Vec3
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import render_sample
from raymarchrenderer.render.raygen import eye_vec, pixel_grid, primary_rays
from raymarchrenderer.scene.graph import Scene


@dataclasses.dataclass
class RenderStats:
    """Aggregated per-sample work profile."""
    pixels: int
    primary_hit_rate: float
    mean_primary_steps: float
    steps_histogram: np.ndarray      # counts per step bucket
    steps_bucket_edges: np.ndarray
    wall_s: float = 0.0

    @property
    def rays_per_s(self) -> float:
        return self.pixels / self.wall_s if self.wall_s > 0 else 0.0

    def to_dict(self) -> dict:
        return {
            "pixels": self.pixels,
            "primary_hit_rate": round(self.primary_hit_rate, 4),
            "mean_primary_steps": round(self.mean_primary_steps, 2),
            "steps_histogram": self.steps_histogram.tolist(),
            "steps_bucket_edges": self.steps_bucket_edges.tolist(),
            "wall_s": round(self.wall_s, 4),
            "rays_per_s": round(self.rays_per_s, 1),
        }


def _primary_profile(scene: Scene, params, cfg: RenderConfig, corners,
                     sample):
    """March the primary segment through the PRODUCTION march with its
    opt-in step counter (`march(..., with_steps=True)`)."""
    from raymarchrenderer.render.integrator import march
    px, py = pixel_grid(cfg.width, cfg.height)
    rng = RNGStream(cfg.seed, px, py, sample, jnp.uint32(1 << 20))
    d = primary_rays(corners, px, py, cfg.width, cfg.height, rng)
    e = eye_vec(corners)
    shape = (cfg.height, cfg.width)
    o = Vec3(jnp.broadcast_to(e.x, shape), jnp.broadcast_to(e.y, shape),
             jnp.broadcast_to(e.z, shape))
    ones = jnp.ones(shape, jnp.float32)
    active = jnp.ones(shape, bool)
    _, _, hit_b, steps = march(scene, params, cfg, o, d, ones, active,
                               with_steps=True)
    return hit_b.astype(jnp.int32), steps


def spectral_path_profile(scene: Scene, params, mats, cfg: RenderConfig,
                          corners, sample, n_samples: int = 4) -> dict:
    """Measured whole-path work profile of the gen-3 spectral transport —
    the numbers behind `bench.py`'s rays/s and map-evals/s (replacing the
    former hardcoded avg-segments estimate).

    Runs `trace_spectral(profile=True)` (the production loop carrying
    per-lane counters) for `n_samples` samples and returns per-sample
    means: path segments marched, march-loop map evals, shaded hits, and
    the derived total map-eval count (march + normal-stencil taps per
    shaded hit; `normal_taps=0` ≈ 2 eval-equivalents via the vjp sweep)."""
    from raymarchrenderer.render.spectral_integrator import trace_spectral

    shape = (cfg.height, cfg.width)
    px, py = pixel_grid(cfg.width, cfg.height)
    e = eye_vec(corners)
    eye = Vec3(jnp.broadcast_to(e.x, shape), jnp.broadcast_to(e.y, shape),
               jnp.broadcast_to(e.z, shape))

    @jax.jit
    def one(s):
        rng = RNGStream(cfg.seed, px, py, s, jnp.uint32(1 << 20))
        d = primary_rays(corners, px, py, cfg.width, cfg.height, rng)
        _, _, segs, msteps, hits = trace_spectral(
            scene, params, mats, cfg, eye, d, px, py, s, profile=True)
        n = float(cfg.width * cfg.height)
        return (jnp.sum(segs) / n, jnp.sum(msteps) / n, jnp.sum(hits) / n)

    acc = np.zeros(3)
    base = int(sample)
    for k in range(n_samples):
        acc += np.asarray(jax.block_until_ready(one(jnp.uint32(base + k))))
    segs, msteps, hits = acc / n_samples
    taps = cfg.normal_taps if cfg.normal_taps > 0 else 2
    # getNormal runs once per bounce ITERATION for the whole tile; per-lane
    # useful work is one stencil per shaded hit (taps map evals each)
    map_evals = msteps + hits * taps
    return {
        "segments_per_sample": round(float(segs), 4),
        "march_map_evals_per_sample": round(float(msteps), 4),
        "hits_per_sample": round(float(hits), 4),
        "map_evals_per_sample": round(float(map_evals), 4),
        "profile_samples": n_samples,
    }


def instrumented_sample(scene: Scene, params, cfg: RenderConfig, corners,
                        sample, n_buckets: int = 16,
                        direct_light: bool = False):
    """One full-frame sample plus its work profile.

    Returns (color (H, W, 3), RenderStats) — call inside or outside jit;
    the stats aggregation is device-side except the final tiny transfers."""
    t0 = time.perf_counter()
    color = render_sample(scene, params, cfg, corners, sample,
                          direct_light=direct_light).stack(-1)
    hitm, steps = _primary_profile(scene, params, cfg, corners, sample)
    edges = np.linspace(0, cfg.max_steps, n_buckets + 1)
    hist = jnp.histogram(steps.astype(jnp.float32),
                         bins=jnp.asarray(edges, jnp.float32))[0]
    color, hitm, steps, hist = jax.block_until_ready(
        (color, hitm, steps, hist))
    wall = time.perf_counter() - t0
    stats = RenderStats(
        pixels=cfg.width * cfg.height,
        primary_hit_rate=float(jnp.mean(hitm.astype(jnp.float32))),
        mean_primary_steps=float(jnp.mean(steps.astype(jnp.float32))),
        steps_histogram=np.asarray(hist),
        steps_bucket_edges=edges,
        wall_s=wall)
    return color, stats


class MetricsLogger:
    """Structured JSONL metrics stream (stdout or file) — the upgrade of the
    reference's `std::cout <<` progress prints."""

    def __init__(self, path: Optional[str] = None):
        self._f = open(path, "a") if path else None

    def log(self, event: str, **fields):
        rec = {"ts": time.time(), "event": event}
        rec.update(fields)
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        else:
            print(line, flush=True)

    def log_stats(self, event: str, stats: RenderStats, **fields):
        self.log(event, **stats.to_dict(), **fields)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


def mega_occupancy_profile(scene, params, mats, cfg, corners, sample,
                           n_samples: int = 8, tiles: int = 8,
                           bh: int = None, bw: int = None,
                           march_unroll: int = None,
                           lazy_miss: bool = None,
                           regen_cadence: int = None) -> dict:
    """Measured masked-lane occupancy of the spectral megakernel schedule
    — the divergence bound of the production kernel.

    Runs `trace_mega_spectral(with_occupancy=True)` on `tiles` (bh, bw)
    tiles spread over the frame (each tile's XLA while_loop has exactly
    the per-tile exit semantics of the Pallas kernel's programs) and
    returns marching-steps / total-steps: the fraction of march_step lane
    slots that actually marched; the rest were parked (hit/miss waiting
    for the next shade pass cadence, or exhausted stragglers)."""
    import numpy as np

    from raymarchrenderer.kernels.march import (DEFAULT_BH, DEFAULT_BW,
                                                DEFAULT_LAZY_MISS,
                                                DEFAULT_MARCH_UNROLL,
                                                DEFAULT_REGEN_CADENCE)
    from raymarchrenderer.render.mega import trace_mega_spectral

    # mirror the production kernel's block and schedule knobs by default
    bh = DEFAULT_BH if bh is None else bh
    bw = DEFAULT_BW if bw is None else bw
    march_unroll = DEFAULT_MARCH_UNROLL if march_unroll is None \
        else march_unroll
    lazy_miss = DEFAULT_LAZY_MISS if lazy_miss is None else lazy_miss
    regen_cadence = DEFAULT_REGEN_CADENCE if regen_cadence is None \
        else regen_cadence

    th, tw = max(cfg.height // bh, 1), max(cfg.width // bw, 1)
    idxs = np.unique(np.linspace(0, th * tw - 1, tiles).astype(int))
    m_tot = 0.0
    t_tot = 0.0

    @functools.partial(jax.jit, static_argnames=("oy", "ox"))
    def one(s, oy, ox):
        py = (oy + jnp.arange(bh, dtype=jnp.int32)[:, None]
              + jnp.zeros((bh, bw), jnp.int32))
        px = (ox + jnp.arange(bw, dtype=jnp.int32)[None, :]
              + jnp.zeros((bh, bw), jnp.int32))
        _, m, t = trace_mega_spectral(scene, params, mats, cfg, corners,
                                      px, py, s, n_samples=n_samples,
                                      shade_gate=0.0,
                                      march_unroll=march_unroll,
                                      lazy_miss=lazy_miss,
                                      regen_cadence=regen_cadence,
                                      with_occupancy=True)
        return jnp.sum(m), jnp.sum(t)

    for ti in idxs:
        i, j = divmod(int(ti), tw)
        m, t = jax.block_until_ready(one(jnp.asarray(sample, jnp.uint32),
                                         i * bh, j * bw))
        m_tot += float(m)
        t_tot += float(t)
    return {
        "march_occupancy": round(m_tot / max(t_tot, 1.0), 4),
        "occupancy_tiles": int(len(idxs)),
        "occupancy_spp": n_samples,
    }
