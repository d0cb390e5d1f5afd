"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is tested without multi-card hardware via
``--xla_force_host_platform_device_count`` (SURVEY.md §4 implication).
Must run before the first jax import anywhere in the test session.
Tests that need a GPU carry the ``gpu`` marker and skip here (see the
``gpu_device`` fixture); run them on a card, in one process, with
``MSBWT_TEST_GPU=1 python -m pytest tests -m gpu -n 0``.
"""

import os

_ON_GPU_RUN = os.environ.get("MSBWT_TEST_GPU") == "1"
if not _ON_GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU_RUN:
    jax.config.update("jax_platforms", "cpu")

import zlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from msbwt_jax.utils.jaxcache import enable_persistent_cache  # noqa: E402

# persistent compile cache across test runs (BCR compiles dominate)
enable_persistent_cache()


def _seed_for(name: str) -> int:
    return zlib.crc32(name.encode()) ^ 0x5EED


@pytest.fixture()
def rng(request):
    """Deterministic per-TEST RNG, seeded from the test's nodeid: draws never
    depend on which other tests ran first on an xdist worker (a session-scoped
    shared rng made test_apps flaky in round 3)."""
    return np.random.default_rng(_seed_for(request.node.nodeid))


@pytest.fixture(scope="module")
def module_rng(request):
    """Deterministic per-MODULE RNG for module-scoped fixtures."""
    return np.random.default_rng(_seed_for(request.node.nodeid))


@pytest.fixture()
def gpu_device():
    """The first GPU device; skips the test when JAX has none. Decided here,
    at run time, never at import (xdist workers must collect the same
    tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r}); "
                    "run with MSBWT_TEST_GPU=1 on a card")
    return dev
