"""Test harness: the suite runs on the CPU, with 8 virtual devices so the
sharding tests run without cards (SURVEY.md §4 item 5).  The Pallas
kernels run here in interpret mode on their Triton route; on a GPU the
compiled kernels are checked by `python chip_smoke.py`, which also runs
the tests marked `gpu` (they skip here).

The CPU is forced through jax.config.update (an ambient JAX_PLATFORMS may
name another backend); XLA_FLAGS is still read from the environment at
(lazy) CPU-client init, so setting it here works as long as no jax
computation has run yet.
"""
import os

# chip_smoke.py runs the `gpu` tests inside its own process on the card
ON_CARD = os.environ.get("RAYMARCH_GPU_TESTS") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not ON_CARD and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# tests drive cli.main()/viewer in-process; never let them bind the
# persistent compile cache to the checkout's .jax_cache
# (test_persistent_compile_cache re-enables it against a tmpdir)
os.environ.setdefault("RAYMARCH_NO_CACHE", "1")

import jax  # noqa: E402
import pytest  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips on the CPU, run on the card "
                   "by `python chip_smoke.py`")


@pytest.fixture
def gpu():
    """Skip unless the default device is a GPU (decided when the test
    runs, never at import: every xdist worker must collect the same
    tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run on the card by chip_smoke.py)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled-executable caches after each test module.

    The full 234-test suite in ONE process segfaults deterministically
    inside pjit execution around test ~165 (any half, and every
    file-pair prefix, passes — it is the CUMULATIVE compiled-program
    state that crosses an XLA:CPU threshold, not any test's own
    computation).  Releasing executables between modules keeps the
    per-process code footprint bounded; within-module jit reuse — where
    almost all cache hits happen — is untouched."""
    yield
    jax.clear_caches()
