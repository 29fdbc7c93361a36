"""Test configuration.

Unless ``JAX_PLATFORMS`` says otherwise, tests run on the CPU with 8 virtual
devices, so the sharding tests get a mesh without accelerators. Tests marked
``gpu`` need an NVIDIA GPU; they skip elsewhere (``gpu_device`` fixture) and
run on the card with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``
(chip_smoke.py runs them in its own process).
"""

import os
import sys

_DEFAULT_CPU = not os.environ.get("JAX_PLATFORMS")
if _DEFAULT_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if _DEFAULT_CPU:
    # Also covers a jax imported before this file (backends initialize
    # lazily, at first use).
    jax.config.update("jax_platforms", "cpu")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

# NOTE: do NOT enable the persistent compile cache here — XLA:CPU AOT
# artifacts bake in compile-machine vector features and warn/SIGILL when the
# execution host differs (observed with +prefer-no-scatter).

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Free compiled executables between test modules: one long-lived
    process accumulating ~100 XLA:CPU compilations eventually segfaults
    inside backend_compile (observed at test #120 of the full suite)."""
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first NVIDIA GPU; skips the test on any other platform."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (default device is {dev.platform})")
    return dev
