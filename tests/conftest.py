"""Test configuration.

Tests run on CPU with 8 simulated devices (multi-device sharding tests
without hardware — SURVEY.md §4 test-parity plan) and float64 enabled (the
parity precision mode: trajectories are compared against NumPy oracles
exactly like the reference's doctest suites compare CppAD against closed
forms).

Tests that need an NVIDIA GPU carry the ``gpu`` marker and the ``card``
fixture, which skips them elsewhere. On the card run them with

    SVGD_TEST_ON_CARD=1 python -m pytest -m gpu tests/

(``SVGD_TEST_ON_CARD=1`` keeps JAX's default backend instead of forcing the
CPU.)
"""

import os

ON_CARD = os.environ.get("SVGD_TEST_ON_CARD") == "1"

_flags = os.environ.get("XLA_FLAGS", "")
if not ON_CARD and "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Set the platform through the config too: it takes effect even where the
# JAX_PLATFORMS environment variable was already read.
if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def card():
    """Skip unless JAX's backend is a GPU (tests marked ``gpu``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "SVGD_TEST_ON_CARD=1 python -m pytest -m gpu tests/")
