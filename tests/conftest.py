"""Test config: repo-root imports, 8 virtual CPU devices for mesh tests, and
the ``gpu`` fixture for tests marked ``gpu``.

Per SURVEY §4: the JAX CPU backend with
``--xla_force_host_platform_device_count=8`` is the "fake multi-device
backend" — sharding tests run on it deterministically.  Tests run on the CPU
unless ``JAX_PLATFORMS`` says otherwise; the card tests run with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX default device: {dev.platform})")
    return dev
