"""Fixtures of the benchmark's tests, imported by the modules that use
them: a temporary checkout of tiny cells (``checkout.make``), shared
within a test module, and a skip where there is no CUDA card."""

import pytest

from bench_port.tests import checkout


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    return checkout.make(tmp), tmp


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
