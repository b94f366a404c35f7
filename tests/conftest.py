"""Test configuration: run on a virtual 8-device CPU mesh by default.

``jax.config.update`` steers the platform even when something imported jax
before this file ran; the environment variable covers a fresh import.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them where no card is visible.  Whether a
card exists is decided inside the fixture, never at import or collection
time, so every pytest-xdist worker collects the same tests.  On a machine
with a card, run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_platforms", platforms)
jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where none is visible")


@pytest.fixture
def gpu_device():
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("no GPU visible: this test runs on the card")
    return devs[0]
