"""Test configuration: CPU backend, 8 virtual devices, 64-bit precision.

Mirrors the reference's CI strategy translated to JAX (SURVEY.md §4): the
1e-13 f64/c128 oracle tolerance is checked on the CPU backend; multi-chip
sharding is tested on a virtual 8-device CPU mesh -- the standard JAX analog
of testing multi-node without a cluster.

Tests marked ``gpu`` (tests/test_gpu.py) need a card; their ``gpu`` fixture
skips them elsewhere.  ``python chip_smoke.py`` runs them on the card, in its
own process: there JAX has already chosen the GPU, and the platform setting
below has no effect.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from blocksparse.utils.compile_cache import use_checkout_cache  # noqa: E402

# The suite is compile-bound on CPU (many distinct bucket-shape graphs);
# the persistent cache makes re-runs fast.
use_checkout_cache(os.path.join(os.path.dirname(__file__), ".."))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided when the test runs)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
