"""Counter-based per-pixel RNG.

The reference uses a stateful per-invocation hash chain (`rand(co)` mixing
`gl_GlobalInvocationID`, `time` and a running `randChange`,
`RayMarch3.glsl:47-61`).  Stateful RNG is hostile to SPMD/XLA, so we replace
it with a *stateless counter-based* generator: every random number is a pure
function of (seed, pixel_x, pixel_y, sample, counter).  This gives

  * bitwise reproducibility between the pure-jnp oracle renderer and the
    Pallas kernels (both call the same integer hash),
  * embarrassing parallelism — shards of pixels/samples need no RNG state
    exchange, so tile/spp sharding is exact, and
  * a well-mixed stream per (pixel, sample, bounce, use) without carrying
    state through `lax.while_loop`.

The hash is lowbias32 (a 2-round xorshift-multiply avalanche with good
avalanche statistics) over a Weyl-sequence combination of the coordinates.
All ops are uint32 adds/mults/xors/shifts — fully VPU-vectorizable.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
# Weyl constants (odd, high-entropy) for decorrelating the input coordinates.
# numpy scalars, NOT jnp: a module-level jnp constant would initialize the
# device backend at import time.
_W0 = np.uint32(0x9E3779B9)
_W1 = np.uint32(0x85EBCA6B)
_W2 = np.uint32(0xC2B2AE35)
_W3 = np.uint32(0x27D4EB2F)


def _avalanche(h):
    """lowbias32 finalizer (Chris Wellons): full-period bijection on uint32."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x846CA68B)
    h = h ^ (h >> 16)
    return h


def hash_u32(a, b, c, d):
    """Mix four uint32 coordinate streams into one well-distributed uint32."""
    a = jnp.asarray(a).astype(_U32)
    b = jnp.asarray(b).astype(_U32)
    c = jnp.asarray(c).astype(_U32)
    d = jnp.asarray(d).astype(_U32)
    h = a * _W0
    h = _avalanche(h + b * _W1)
    h = _avalanche(h + c * _W2)
    h = _avalanche(h + d * _W3)
    return h


def bits_to_uniform(bits):
    """uint32 -> float32 uniform in [0, 1) using the top 24 bits.

    The intermediate int32 cast is exact (24-bit values), and a signed
    int->float conversion is the one every backend lowers."""
    return ((bits >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32)
            * jnp.float32(1.0 / (1 << 24)))


class PixelRNG:
    """A cheap stream handle: fixes (seed, px, py, sample) and hands out
    uniforms indexed by an incrementing use-counter.

    The counter is plain Python when the call pattern is static (unrolled
    bounces in trace-time-compiled materials) or a traced uint32 when used
    inside lax loops — both work since the hash is pure.
    """

    __slots__ = ("seed", "px", "py", "base")

    def __init__(self, seed, px, py, sample):
        self.seed = jnp.asarray(seed).astype(_U32)
        self.px = jnp.asarray(px).astype(_U32)
        self.py = jnp.asarray(py).astype(_U32)
        # Fold (seed, sample) into one stream id so per-use hashing is 4-way.
        self.base = _avalanche(self.seed * _W2
                               + jnp.asarray(sample).astype(_U32) * _W3)

    def at(self, counter):
        """Uniform [0,1) for an explicit use-counter (traced or static)."""
        return bits_to_uniform(hash_u32(self.px, self.py, self.base, counter))

    def bits(self, counter):
        return hash_u32(self.px, self.py, self.base, counter)


def uniform(seed, px, py, sample, counter):
    """One-shot functional form of PixelRNG.at."""
    base = _avalanche(jnp.asarray(seed).astype(_U32) * _W2
                      + jnp.asarray(sample).astype(_U32) * _W3)
    return bits_to_uniform(hash_u32(px, py, base, counter))


class RNGStream:
    """Trace-time counter allocator over the counter-based hash.

    Every `.next()` call burns one statically-numbered slot of the
    (px, py, base) stream, where `base` may fold in *traced* values (sample
    index, bounce index).  Because the slot number is assigned at trace time,
    the same code path always consumes the same slots — the generator is
    stateless across pixels, samples and shards, which is what makes tile/spp
    sharding exact (SURVEY.md §5 long-context note).

    Replaces the reference's stateful hash chain `rand()`
    (`RayMarch3.glsl:47-61`) whose sequential state would serialize SPMD.
    """

    __slots__ = ("px", "py", "base", "_s2", "_counter")

    def __init__(self, seed, px, py, *folds):
        self.px = jnp.asarray(px).astype(_U32)
        self.py = jnp.asarray(py).astype(_U32)
        base = jnp.asarray(seed).astype(_U32) * _W2
        for f in folds:
            base = _avalanche(base + jnp.asarray(f).astype(_U32) * _W3)
        self.base = base
        self._s2 = None
        self._counter = 0

    def _stage2(self):
        """The draw-invariant prefix of `hash_u32(px, py, base, ctr)`.

        hash_u32 is a left fold, so the first three mixing rounds depend
        only on (px, py, base) — shared by every draw of the stream.
        Caching it makes each `.next()` one avalanche round instead of
        three (the hot shade pass draws 3-5 uniforms per stream); the bit
        stream is IDENTICAL (same op DAG, explicitly factored instead of
        relying on backend CSE)."""
        if self._s2 is None:
            s1 = _avalanche(self.px * _W0 + self.py * _W1)
            self._s2 = _avalanche(s1 + self.base * _W2)
        return self._s2

    def next(self):
        """Fresh uniform [0,1) array broadcast over the pixel coords."""
        self._counter += 1
        return bits_to_uniform(
            _avalanche(self._stage2() + jnp.uint32(self._counter) * _W3))

    def next_bits(self):
        self._counter += 1
        return _avalanche(self._stage2() + jnp.uint32(self._counter) * _W3)

    def fork(self, tag: int) -> "RNGStream":
        """Independent substream (e.g. per light) without slot collisions."""
        child = RNGStream.__new__(RNGStream)
        child.px, child.py = self.px, self.py
        child.base = _avalanche(self.base + jnp.uint32(tag) * _W1)
        child._s2 = None
        child._counter = 0
        return child


def key_for(seed: int, *folds: int) -> jax.Array:
    """A jax.random key derived from the same seed space, for host-side
    utilities (checkpoint resume, jitter shuffling) that want jax.random."""
    k = jax.random.key(seed)
    for f in folds:
        k = jax.random.fold_in(k, f)
    return k
