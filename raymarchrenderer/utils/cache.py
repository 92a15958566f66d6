"""Persistent XLA compilation cache for the product frontends.

The reference recompiles its compute shader on every scene reload
(`Graphics.cpp:741-742`) and eats the cost interactively; our analogue is
the compile of the fused render program, which dwarfs a preview render.
JAX ships a persistent compilation cache keyed on the lowered program;
wiring it into the CLI, the viewer, `bench.py` and `chip_smoke.py` means
a user pays the compile ONCE per (shape, schedule) across processes.

Where the cache lives is decided outside the program:

    JAX_COMPILATION_CACHE_DIR=<path>   JAX uses it; nothing else is set
    (unset)                            <checkout>/.jax_cache/ (a fixed
                                       path: the path is part of the key)
    RAYMARCH_NO_CACHE=1                disabled (or `--no-cache`)
"""
from __future__ import annotations

import os

# <checkout>/.jax_cache/, listed in .gitignore
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_persistent_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.  Returns the cache dir
    in use, or None when disabled or the checkout is read-only (a render
    never fails because of the cache)."""
    if os.environ.get("RAYMARCH_NO_CACHE", "0") == "1":
        return None
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        # JAX reads the variable itself; setting anything here would
        # override the caller's choice
        return env_dir
    import jax
    from jax.experimental.compilation_cache import compilation_cache as _cc
    try:
        os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
    except OSError:
        return None
    # config.update alone does NOT re-point a cache backend that a
    # previous compile already initialized — reset it so the dir takes
    # effect mid-process
    changed = jax.config.jax_compilation_cache_dir != CHECKOUT_CACHE_DIR
    _cc.set_cache_dir(CHECKOUT_CACHE_DIR)
    if changed:
        _cc.reset_cache()
    # cache every compile: a CLI render issues a dozen small programs
    # before the kernel, each as worth skipping as the big one
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return CHECKOUT_CACHE_DIR
