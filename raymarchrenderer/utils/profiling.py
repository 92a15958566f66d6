"""Profiling helpers: `jax.profiler` traces + blocking wall timers.

The reference measures wall time with `clock()` around the render loop
(`Program.cpp:129-134,191-192`) and once measured shader compile time
(`Graphics.cpp:197-198`, print commented out).  The equivalents here are
(a) a `block_until_ready`-bracketed timer that separates compile (first
call) from steady-state, (b) an XLA profiler trace viewable in
TensorBoard / xprof, and (c) the device a number was measured on."""
from __future__ import annotations

import contextlib
import subprocess
import time

import jax


@contextlib.contextmanager
def timed_block(label: str = "", result: dict = None):
    """Wall-time a block, blocking on all outstanding device work at exit.
    `result` (optional dict) receives {label: seconds}."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        jax.effects_barrier()
        dt = time.perf_counter() - t0
        if result is not None:
            result[label or "block"] = dt


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a jax.profiler trace (HLO timeline, per-op device time) for
    everything inside the block."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def compile_and_steady(fn, *args, reps: int = 3):
    """Split first-call (compile) time from best steady-state time.
    Returns (compile_s, steady_s, last_output)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return compile_s, best, out


def gpu_name_power() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (first line) — every
    GPU number is reported beside it, since a card set below its maximum
    power runs slower under load.  "not measured" where there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not measured"
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else "not measured"


def device_report() -> dict:
    """What JAX runs on: platform, device kind and count, plus the
    `nvidia-smi` name and power limit."""
    dev = jax.devices()
    return {"platform": dev[0].platform, "kind": dev[0].device_kind,
            "count": len(dev), "nvidia_smi": gpu_name_power()}
