"""Which implementation renders on the default device.

One place decides it for every frontend (CLI, viewer, tiles, parity,
bench, tools): the Pallas kernels compiled through Triton on a GPU, the
plain-jnp oracle on the CPU.  Anything else is refused rather than
silently rendered on a path nobody measured.
"""
from __future__ import annotations

import jax

TRITON = "triton"
ORACLE = "oracle"


def kernel_route(platform: str | None = None) -> str:
    """`"triton"` on a GPU, `"oracle"` on the CPU; raises otherwise.

    `platform` defaults to the default device's (`jax.devices()[0]`)."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform == "gpu":
        return TRITON
    if platform == "cpu":
        return ORACLE
    raise RuntimeError(f"no kernel route for platform {platform!r}: the "
                       "renderer runs on a GPU (Pallas/Triton) or the CPU "
                       "(plain-jnp oracle)")
