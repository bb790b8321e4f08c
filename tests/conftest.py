"""Pytest config: force an 8-virtual-device CPU JAX before any backend init.

Tests run on CPU (SURVEY §4: the reference suite is single-process and
deterministic; multi-device sharding is validated on a virtual CPU mesh per
SNIPPETS.md pattern [1]). This must execute before jax initializes a
backend, hence the env mutation at module import time.
"""

import os

# QINFER_TEST_PLATFORM=gpu keeps the ambient (GPU) backend so the tests
# marked ``gpu`` (tests/test_gpu.py) can run on the card:
#   QINFER_TEST_PLATFORM=gpu python -m pytest tests/test_gpu.py -m gpu -q
# Everything else runs on the forced 8-virtual-device CPU.
_ON_GPU = os.environ.get("QINFER_TEST_PLATFORM") == "gpu"

if not _ON_GPU:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _derandomize():
    """Reference pattern: ``tests/base_test.py — DerandomizedTestCase``
    (fixed seed in setUp). JAX PRNG keys are explicit, but host-side NumPy
    randomness (oracle, geometry helpers) is seeded here."""
    np.random.seed(0)
    yield


@pytest.fixture
def key():
    return jax.random.key(0)
