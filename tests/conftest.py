"""Test configuration: run everything on a virtual 8-device CPU mesh with
float64 enabled, so golden comparisons against the NumPy oracle are tight and
sharding tests exercise real multi-device code paths without accelerators
(SURVEY.md section 4). Tests that need a GPU carry the ``gpu`` marker and
skip here through the ``gpu_device`` fixture; `python chip_smoke.py` runs
them on the card."""

import os

# BETACORES_GPU_TESTS=1 (set by chip_smoke.py, which runs the gpu-marked
# tests in its own process on the card) leaves the platform and dtypes as
# the calling process has them.
GPU_RUN = os.environ.get("BETACORES_GPU_TESTS") == "1"

if not GPU_RUN:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if not GPU_RUN:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: the suite is compile-bound on small hosts
# (measured: the slowest sharded test drops 40.6 s -> 18.6 s warm), so cache
# compiled programs across runs in a repo-local dir (gitignored). Keyed on
# HLO + jax/XLA version + flags, so code changes invalidate exactly the
# affected entries. Env vars still win for CI that wants its own location.
if not GPU_RUN and "JAX_COMPILATION_CACHE_DIR" not in os.environ:
    _cache = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          ".cache", "jax_test_compile")
    os.makedirs(_cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
# Promote FP anomalies to hard errors, the JAX equivalent of the reference's
# np.seterr(all='raise') in tests (reference tests/test_snnls/test_deterministic.py:6).
jax.config.update("jax_debug_nans", False)  # enabled selectively in tests

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at import
    (every xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return jax.devices()[0]
