"""Test config: the suite runs on a virtual 8-device CPU mesh, so mesh and
sharding logic is testable without accelerators.

Tests marked `gpu` need an NVIDIA GPU: the `gpu` fixture skips them
anywhere else.  On a machine with a card, run them with

    BIC_TEST_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

# must land before the CPU client is created
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms",
                  os.environ.get("BIC_TEST_PLATFORMS", "cpu"))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def gpu():
    """The GPU device; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return dev


@pytest.fixture
def rng():
    return np.random.RandomState(12345)


def pytest_report_header(config):
    return f"jax devices: {jax.devices()}"
