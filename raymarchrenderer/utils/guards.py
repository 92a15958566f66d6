"""Numeric guards: NaN/Inf detection inside the jitted render.

The GLSL reference has no sanitizers (SURVEY.md §5) — bad math silently
paints pixels black.  Here `jax.experimental.checkify` instruments the same
production `render_sample` with float checks, so a debug run pinpoints the
first NaN/Inf-producing op with a real traceback instead of a corrupt
image.  Zero cost when unused: the checked function is built on demand."""
from __future__ import annotations

import functools

import jax
from jax.experimental import checkify

from raymarchrenderer.render.config import RenderConfig
from raymarchrenderer.render.integrator import render_sample
from raymarchrenderer.scene.graph import Scene


@functools.partial(jax.jit, static_argnums=(0, 2, 5))
def _checked(scene, params, cfg, corners, sample, direct_light):
    fn = checkify.checkify(
        lambda p: render_sample(scene, p, cfg, corners, sample,
                                direct_light=direct_light).stack(-1),
        errors=checkify.float_checks)
    return fn(params)


def checked_render_sample(scene: Scene, params, cfg: RenderConfig, corners,
                          sample, direct_light: bool = False,
                          throw: bool = True):
    """One full-frame sample under checkify float checks.

    Returns (err, image); with `throw=True` (default) raises on the first
    NaN/Inf instead."""
    err, img = _checked(scene, params, cfg, corners, sample, direct_light)
    if throw:
        checkify.check_error(err)
    return err, img
