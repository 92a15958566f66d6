"""Failure detection / elastic recovery for distributed renders.

The reference has no failure story (single GL context; the closest
analogue is Escape-cancel keeping the partial accumulation,
`Program.cpp:188-194`).  The story here (SURVEY.md §5) exploits the
estimator's algebra: progressive rendering is a MEAN OVER SAMPLES, and
sample accumulation is associative and commutative — so work can be cut
into independent spp shards, each shard's result is a raw per-pixel SUM
over its samples, and the merge divides once by the number of samples
that actually arrived.  A shard lost to a failed host/chip is either
re-run (retry budget) or dropped; a dropped shard just lowers the
effective spp — the image stays an unbiased estimate, exactly as if the
user had asked for fewer samples.

Counter-based RNG (core/rng.py) is what makes re-running exact: a
shard's samples are keyed by absolute sample index, so a retried shard
reproduces bit-identical sums no matter where or when it runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class ShardFailure:
    """Record of one failed shard execution."""
    sample0: int
    n_samples: int
    attempt: int
    error: str
    ts: float


@dataclasses.dataclass
class ElasticResult:
    image: np.ndarray            # (H, W, 3) mean over achieved samples
    spp_requested: int
    spp_achieved: int            # == requested unless shards were dropped
    failures: List[ShardFailure]
    dropped_shards: List[int]    # sample0 of shards lost for good

    @property
    def degraded(self) -> bool:
        return self.spp_achieved < self.spp_requested


def render_elastic(run_shard: Callable, height: int, width: int, spp: int,
                   shard_spp: int = 8, max_retries: int = 1,
                   logger=None) -> ElasticResult:
    """Drive `run_shard(sample0, n_samples) -> (H, W, 3) raw sample SUM`
    over ceil(spp/shard_spp) shards with failure detection + retry.

    `run_shard` is the distribution boundary: locally it wraps a jitted
    render; multi-host it wraps a collective or an RPC to a worker pool.
    Any exception it raises is treated as a shard failure: the shard is
    retried up to `max_retries` times and then DROPPED — the merge
    normalizes by the samples that actually arrived ("lost spp shards
    lower effective spp"), so the returned image is always a valid,
    unbiased (just noisier) estimate.
    """
    total = np.zeros((height, width, 3), np.float32)
    achieved = 0
    failures: List[ShardFailure] = []
    dropped: List[int] = []

    for s0 in range(0, spp, shard_spp):
        k = min(shard_spp, spp - s0)
        got = None
        for attempt in range(max_retries + 1):
            try:
                got = np.asarray(run_shard(s0, k), np.float32)
                break
            except Exception as e:  # failure detection boundary
                failures.append(ShardFailure(
                    sample0=s0, n_samples=k, attempt=attempt,
                    error=f"{type(e).__name__}: {e}", ts=time.time()))
                if logger is not None:
                    logger.log("shard_failure", sample0=s0, attempt=attempt,
                               error=str(e))
        if got is None:
            dropped.append(s0)
            if logger is not None:
                logger.log("shard_dropped", sample0=s0, n_samples=k)
            continue
        total += got
        achieved += k

    img = total / max(achieved, 1)
    return ElasticResult(image=img, spp_requested=spp, spp_achieved=achieved,
                         failures=failures, dropped_shards=dropped)


def oracle_shard_fn(scene, params, cfg, corners,
                    direct_light: bool = False) -> Callable:
    """A local `run_shard` over the oracle integrator: raw per-pixel sum of
    samples [sample0, sample0+n) — counter-keyed, so a retry is bitwise."""
    from raymarchrenderer.render.integrator import render_sample

    def run(sample0: int, n: int):
        acc = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
        for s in range(sample0, sample0 + n):
            acc = acc + render_sample(scene, params, cfg, corners,
                                      jnp.uint32(s),
                                      direct_light=direct_light).stack(-1)
        return acc

    return run


def fused_shard_fn(scene, params, cfg, corners, block=None,
                   interpret: bool = False) -> Callable:
    """A local `run_shard` over the fused Pallas kernel (raw sums via
    `normalize=False` — the same bitwise-merge contract used by
    `parallel.sharding.render_sharded`)."""
    from raymarchrenderer.kernels.march import (DEFAULT_BH, DEFAULT_BW,
                                                    render_fused_patch)
    blk = block or (DEFAULT_BH, DEFAULT_BW)

    def run(sample0: int, n: int):
        return render_fused_patch(
            scene, params, cfg, corners, (0, 0),
            (cfg.height, cfg.width), jnp.uint32(sample0), n_samples=n,
            block=blk, interpret=interpret, normalize=False)

    return run
