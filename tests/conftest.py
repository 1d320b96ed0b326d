"""Test configuration.

Tests run on CPU with 8 virtual devices (the shard_map/mesh analog of the
reference CI's 1-vs-2-thread determinism legs, ``.github/workflows/CI.yml``)
and with x64 enabled so f32 results can be validated against f64 ground
truth, mirroring the reference tests' Float32-vs-Float64 sweeps. Tests
marked ``gpu`` need a CUDA GPU and skip elsewhere; run them on a GPU
machine with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# the CPU unless the caller names another platform (the gpu tests)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# the repository's scripts (bench.py, chip_smoke.py, __graft_entry__.py,
# compile_cache.py) are tested too
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import jax

from compile_cache import use_compile_cache

# jax may already have been imported by a pytest plugin, after which the
# JAX_PLATFORMS env var is no longer consulted — set the config directly
# (legal as long as no backend has been initialized yet).
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
# Persistent compile cache for the suite (the scripts' cache, see
# compile_cache.py): compiled CPU executables are reused across the
# per-module jax.clear_caches() below AND across suite runs (the in-memory
# caches are dropped but the on-disk cache survives), cutting most of the
# recompile cost the segfault workaround introduced. Keyed by jaxlib
# version + flags, so stale entries are never reused.
use_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    With the full suite in one process (~400 compiled programs), jaxlib's
    CPU compiler eventually segfaults inside backend_compile — observed
    deterministically around the 150th test regardless of which test runs
    there (raising the stack rlimit does not help, and any subset of the
    suite passes). Dropping the pjit/executable caches between modules
    keeps the compiler's accumulated state bounded; per-module recompiles
    are the (small) price, mostly paid back by the persistent compile
    cache configured above. A standalone repro was attempted
    (``benchmarks/repro_jaxlib_segfault.py``: 500 scan+cholesky programs
    compile fine), so the trigger is specific to the suite's large
    programs; set ``PATHFINDER_KEEP_JAX_CACHES=1`` to disable this
    workaround when re-testing on a newer jaxlib.
    """
    yield
    if not os.environ.get("PATHFINDER_KEEP_JAX_CACHES"):
        jax.clear_caches()
