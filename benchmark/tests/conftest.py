import pathlib
import sys

import pytest

# the checkout's root, for ``benchmark`` and the port
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


@pytest.fixture
def cuda():
    """Skips where there is no card (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda", 0)
