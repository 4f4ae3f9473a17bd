"""Fixtures of the harness's tests: one tiny throwaway benchmark for the
whole test run, written as files under a temporary root."""

import pytest
import torch

from gcbench.tests import tiny

# several workers share the cores
torch.set_num_threads(2)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    tiny.write_bench(str(root))
    return str(root)


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
