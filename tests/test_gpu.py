"""Checks that need an NVIDIA GPU: the flagship-scale accuracy gates and
the update and pick equality at full width, as run by phases b and d of
``chip_smoke.py``. On the card:

    QINFER_TEST_PLATFORM=gpu python -m pytest tests/test_gpu.py -m gpu -q

Elsewhere they skip.
"""

import jax
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "QINFER_TEST_PLATFORM=gpu")


def test_flagship_and_conjugate_beta_gate(gpu):
    import chip_smoke

    chip_smoke.phase_b_flagship()


def test_update_and_pick_equality_at_full_width(gpu):
    import chip_smoke

    chip_smoke.phase_d_equality()
