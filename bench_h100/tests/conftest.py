import pytest
import torch


@pytest.fixture
def card():
    """Skips a test on a host without a CUDA card (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def pytest_configure(config):
    # several test processes share the host's cores
    torch.set_num_threads(2)
