import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none (decided
    inside the test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return "cuda"
