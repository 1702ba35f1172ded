"""Test configuration: run on a simulated 8-device CPU mesh with x64 enabled.

Multi-device behavior is tested the standard JAX way
(``--xla_force_host_platform_device_count``); x64 matches the float64 NumPy
oracles that mirror the reference implementation.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them on the CPU; ``chip_smoke.py`` runs the same paths
on the card. On a GPU host they run with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu -p no:xdist``.
"""
import os

# The suite runs on the CPU backend unless JAX_PLATFORMS names another:
# set the platform before JAX initializes a backend.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on the CPU backend)")


@pytest.fixture
def gpu():
    """The first GPU device, or a skip. Decided when the test runs, never
    at import or collection, so every xdist worker collects the same
    tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; this run is on the CPU backend")
    return devices[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The XLA CPU backend segfaults inside ``backend_compile_and_load``
    after ~175 modules' worth of compilations accumulate in one process
    (reproduced twice at ~93-98% of the suite, with and without the
    native extension loaded; not memory pressure). Dropping the caches at
    module boundaries keeps the per-process executable count bounded;
    cross-module cache reuse was negligible anyway (each module compiles
    its own shapes)."""
    yield
    import jax

    jax.clear_caches()
