"""Test configuration: JAX on a virtual 8-device CPU mesh (unless
JAX_PLATFORMS names another platform, or JAX is already running) so the
multi-device sharding paths compile and run without accelerators.

Tests that need a GPU are marked `gpu` and take the `gpu` fixture, which
skips them without one; `python chip_smoke.py` runs them on the card."""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py there)")
