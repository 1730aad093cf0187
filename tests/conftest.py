"""Test config: force the CPU backend with an 8-device virtual mesh.

Config updates (not only JAX_PLATFORMS) pin the CPU, because they take
effect whatever the environment set, as long as no backend has started
yet.  Multi-device sharding tests then run on 8 virtual CPU devices.

Tests that need an NVIDIA GPU carry the `gpu` marker and request the
`gpu_device` fixture, which skips them here; `python chip_smoke.py` runs
the same checks on the card.
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on the CPU backend)")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided per test, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run python chip_smoke.py on one")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
