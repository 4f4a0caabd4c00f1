"""Checks that need the GPU: every Pallas Jacobi kernel compiled for the
card at its production widths against the f64 reference.

They skip on the CPU (tests/conftest.py pins the test process to it).
``python chip_smoke.py`` runs the same checks on the card in its own
process; so does ``pytest -m gpu tests/test_gpu.py`` in a process that
sees the GPU."""

import jax
import pytest

from code_robchar_tpu.ops import kernel_check

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU; chip_smoke.py runs these checks on "
                    "the card")


@pytest.mark.parametrize("b", [1024, 1153, 65536])
@pytest.mark.parametrize("n", [4, 7, 10])
@pytest.mark.parametrize("kind", kernel_check.KINDS)
def test_kernel_matches_f64_reference_on_card(gpu, kind, n, b):
    row = kernel_check.check_kernel(kind, n, b)
    assert row["ok"], row
