"""Tile scheduling: the reference's spiral chunk walk + progressive driver.

`Program.cpp:107-299` splits the image into a gridW×gridH chunk grid and
walks it in a square spiral from the centre outward, rendering all samples
of a tile before advancing (samples>0 mode) or one sample per tile per pass
(samples==0 endless mode).  `spiral_tiles` reproduces the exact visit order
(including its off-centre start `ceil(g/2)-1` and the
distCount/squaresPassed turn bookkeeping).

On the GPU the full frame fits one kernel launch, so tiling is not needed for
throughput — it exists for (a) interactive progressive preview parity,
(b) bounded-memory rendering of huge frames, and (c) the unit of work that
`parallel` shards across chips.  Tiles share one compiled program: the tile
origin is a dynamic argument; only the (static) tile shape is compiled in.
"""
from __future__ import annotations

import functools
from typing import Iterator, Tuple

import jax
import jax.numpy as jnp

from raymarchrenderer.core.rng import RNGStream
from raymarchrenderer.core.vecmath import Vec3
from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import trace_rgb
from raymarchrenderer.render.raygen import eye_vec, primary_rays


def spiral_tiles(grid_w: int, grid_h: int) -> Iterator[Tuple[int, int]]:
    """Yield (x, y) tile coords in the reference's spiral order
    (`Program.cpp:113-119,196-299`).  Tiles outside the grid are skipped on
    yield but still traversed (the reference renders them as empty bounds).

    Uses the native C++ scheduler (`native/scheduler.cpp`) when built; the
    pure-Python walk `spiral_tiles_py` is the fallback and emits the
    identical order."""
    try:
        from raymarchrenderer.render import scheduler_native
        if scheduler_native.available():
            yield from scheduler_native.spiral_order(grid_w, grid_h)
            return
    except Exception:
        pass
    yield from spiral_tiles_py(grid_w, grid_h)


def spiral_tiles_py(grid_w: int, grid_h: int) -> Iterator[Tuple[int, int]]:
    """Pure-Python spiral walk (exact `Program.cpp:203-222` bookkeeping)."""
    x = -(-grid_w // 2) - 1   # ceil(g/2) - 1
    y = -(-grid_h // 2) - 1
    dx, dy = -1, 0
    squares = 0
    last_squares = 0
    dist_count = 0
    remaining = grid_w * grid_h
    # The reference stops after gridW*gridH steps, which silently skips tiles
    # on non-square grids (out-of-grid spiral steps consume the budget,
    # `Program.cpp:206-216,239`).  We keep walking until every in-grid tile
    # has been emitted — identical order on square grids, complete coverage
    # on rectangular ones.
    while remaining > 0:
        if 0 <= x < grid_w and 0 <= y < grid_h:
            yield (x, y)
            remaining -= 1
        # advance (exact bookkeeping from Program.cpp:203-222)
        x -= grid_w // 2
        y -= grid_h // 2
        if dist_count * 2 == squares - last_squares:
            dist_count += 1
            last_squares = squares
            dx, dy = dy, -dx
        elif dist_count == squares - last_squares:
            dx, dy = dy, -dx
        squares += 1
        x += dx
        y += dy
        x += grid_w // 2
        y += grid_h // 2


@functools.partial(jax.jit, static_argnums=(0, 2, 3, 9))
def _tile_sample(scene, params, cfg: RenderConfig, tile_shape, corners,
                 origin_xy, accum, n, sample, direct_light=False):
    """Render one sample of one tile and merge it into the accumulation
    buffer (running mean keyed by per-tile sample count n)."""
    th, tw = tile_shape
    oy = origin_xy[1]
    ox = origin_xy[0]
    py = (jnp.arange(th, dtype=jnp.int32)[:, None] + oy) * jnp.int32(1)
    px = (jnp.arange(tw, dtype=jnp.int32)[None, :] + ox) * jnp.int32(1)
    px = jnp.broadcast_to(px, (th, tw))
    py = jnp.broadcast_to(py, (th, tw))

    rng = RNGStream(cfg.seed, px, py, sample, jnp.uint32(1 << 20))
    d = primary_rays(corners, px, py, cfg.width, cfg.height, rng)
    e = eye_vec(corners)
    eye = Vec3(jnp.broadcast_to(e.x, (th, tw)),
               jnp.broadcast_to(e.y, (th, tw)),
               jnp.broadcast_to(e.z, (th, tw)))
    channels = Vec3.full((th, tw), 1.0, 1.0, 1.0)
    color = trace_rgb(scene, params, cfg, eye, d, px, py, sample, channels,
                      direct_light)

    f1 = 1.0 / (n + 1.0)
    f2 = n / (n + 1.0)
    old = jax.lax.dynamic_slice(accum, (oy, ox, 0), (th, tw, 3))
    new = color.stack(-1) * f1 + old * f2
    return jax.lax.dynamic_update_slice(accum, new, (oy, ox, 0))


class ProgressiveRenderer:
    """Stateful progressive driver with the reference's two modes
    (`Program.cpp:182-299`): finite samples (all spp of a tile, then spiral
    to the next) and endless (samples=0: one sample per tile per pass).

    The accumulation buffer is always a valid partial image — rendering can
    stop at any moment and be saved or checkpointed (Escape-to-cancel /
    S-to-save parity, `Program.cpp:188-194,303-306`).

    `impl`: "oracle" = per-sample pure-XLA tiles (the CPU/testing path);
    "triton" = each tile's full sample budget in ONE megakernel launch —
    the reference's defining progressive-refinement UX on the ACTIVE
    kernel (`Program.cpp:184-299` driving `RayMarch3.glsl`), at the
    product kernel's rate instead of the oracle's.  "auto" asks
    `kernels.route.kernel_route`.  Both produce identical images (the
    kernel is bitwise-equal to the full-frame kernel render; oracle vs
    kernel differ only at the known FMA-contraction level between
    compilations)."""

    def __init__(self, scene, params, cfg: RenderConfig, corners,
                 impl: str = "auto", direct_light: bool = False,
                 interpret: bool = False):
        self.scene = scene
        self.params = params
        self.cfg = cfg
        self.corners = corners
        self.direct_light = direct_light
        self.interpret = interpret
        if impl == "auto":
            from raymarchrenderer.kernels.route import kernel_route
            impl = kernel_route()
        self.impl = impl
        if cfg.width % cfg.grid_width or cfg.height % cfg.grid_height:
            raise ValueError("image size must be divisible by the tile grid "
                             "(reference integer-division behavior)")
        self.tile_shape = (cfg.height // cfg.grid_height,
                           cfg.width // cfg.grid_width)
        self.accum = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
        self.pass_n = 0.0

    def _tile_origin(self, tx: int, ty: int):
        th, tw = self.tile_shape
        return jnp.asarray([tx * tw, ty * th], jnp.int32)

    def _merge_fused(self, origin, tile, n, k):
        """Running mean over launch chunks: new = (old*n + tile*k)/(n+k)."""
        th, tw = self.tile_shape
        oy, ox = int(origin[1]), int(origin[0])
        old = jax.lax.dynamic_slice(self.accum, (oy, ox, 0), (th, tw, 3))
        new = (old * n + tile * k) / (n + k)
        return jax.lax.dynamic_update_slice(self.accum, new, (oy, ox, 0))

    def render_pass(self, spp: int = None, callback=None):
        """Finite mode: every tile gets `spp` samples, spiral order."""
        cfg = self.cfg
        spp = cfg.spp if spp is None else spp
        for tx, ty in spiral_tiles(cfg.grid_width, cfg.grid_height):
            origin = self._tile_origin(tx, ty)
            if self.impl == "triton":
                tile = render_fused_patch_for_tiles(
                    self.scene, self.params, cfg, self.corners, origin,
                    self.tile_shape, 0, spp, self.direct_light,
                    self.interpret)
                self.accum = self._merge_fused(origin, tile, 0.0, float(spp))
            else:
                for s in range(spp):
                    self.accum = _tile_sample(
                        self.scene, self.params, cfg, self.tile_shape,
                        self.corners, origin, self.accum, jnp.float32(s),
                        jnp.uint32(s), self.direct_light)
            if callback is not None:
                callback(tx, ty, self.accum)
        self.pass_n = float(spp)
        return self.accum

    def endless_passes(self, n_passes: int, callback=None):
        """samples==0 mode: one sample per tile per pass, repeated."""
        cfg = self.cfg
        for p in range(n_passes):
            for tx, ty in spiral_tiles(cfg.grid_width, cfg.grid_height):
                origin = self._tile_origin(tx, ty)
                if self.impl == "triton":
                    tile = render_fused_patch_for_tiles(
                        self.scene, self.params, cfg, self.corners, origin,
                        self.tile_shape, int(self.pass_n), 1,
                        self.direct_light, self.interpret)
                    self.accum = self._merge_fused(origin, tile,
                                                   self.pass_n, 1.0)
                else:
                    self.accum = _tile_sample(
                        self.scene, self.params, cfg, self.tile_shape,
                        self.corners, origin, self.accum,
                        jnp.float32(self.pass_n),
                        jnp.uint32(int(self.pass_n)), self.direct_light)
            self.pass_n += 1.0
            if callback is not None:
                callback(p, self.accum)
        return self.accum


def render_fused_patch_for_tiles(scene, params, cfg, corners, origin,
                                 tile_shape, sample0, n_samples,
                                 direct_light, interpret):
    """All `n_samples` of one tile in ONE megakernel launch — the product
    kernel under the interactive driver.  One compiled program per tile
    SHAPE (`render_fused_patch` is jitted on static shape; the origin is
    a dynamic argument), so the spiral walk reuses a single executable.
    Bitwise-equal to the same pixels of a full-frame `render_fused`: the
    RNG is keyed on absolute pixel coords and every per-lane value is
    schedule-invariant (the megakernel's passes decide WHEN a lane is
    shaded, never WHAT it computes), so the tile decomposition doesn't
    touch the numbers (asserted in tests/test_tiles_fused.py)."""
    from raymarchrenderer.kernels.march import render_fused_patch
    return render_fused_patch(scene, params, cfg, corners, origin,
                              tile_shape, jnp.uint32(sample0),
                              n_samples=n_samples,
                              direct_light=direct_light,
                              interpret=interpret)
