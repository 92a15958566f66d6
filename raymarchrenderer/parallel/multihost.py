"""Multi-host runtime: `jax.distributed` init + host-0 gather.

The reference has no distributed communication backend (single GL context;
SURVEY.md §2) — its host↔device traffic is uniform upload down and
`glReadPixels` up (`Graphics.cpp:316-348,759`).  The equivalent here
splits by interconnect:

  * device interconnect: all render collectives (`psum` spp merges, grad
    all-reduces) live inside `shard_map` programs — see
    `parallel.sharding`;
  * host network: only process bootstrap (`jax.distributed.initialize`),
    the host-0 framebuffer gather for saving, and checkpoint I/O cross it.

Everything here degrades gracefully to single-process (the common dev
loop): `init()` is a no-op without coordinator info, and the gather helpers
fall back to plain `device_get`.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> bool:
    """Initialize `jax.distributed` for a multi-host run.

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    Returns True if distributed mode is active."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        # single process (or a runtime that already initialized)
        return jax.process_count() > 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    return jax.process_count() > 1


def is_primary() -> bool:
    return jax.process_index() == 0


def gather_to_host0(img) -> Optional[np.ndarray]:
    """Materialize a (possibly cross-process sharded) device image on host
    process 0 — the multi-host `glReadPixels` (`Graphics.cpp:759`).

    Returns the full array on process 0, None elsewhere.  Single-process:
    plain device_get."""
    if jax.process_count() == 1:
        return np.asarray(jax.device_get(img))
    from jax.experimental import multihost_utils
    full = multihost_utils.process_allgather(img, tiled=True)
    return np.asarray(full) if is_primary() else None


def sync() -> None:
    """Cross-process barrier (no-op single-process)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("raymarch-sync")
