import pathlib
import sys

import pytest

# the checkout's root, for ``benchmark`` and the port
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

# small sizes of each configuration for runs on the CPU: a coarse grid
# and its bergs crowded into the two degrees off the coast, so that
# contacts, spawns and bounces all happen
TINY = {
    "om4_coupled": {"grid": {"nx": 360, "ny": 240, "seed_north_of": -68.0},
                    "bergs": {"n": 12000, "capacity": 16384}},
}


@pytest.fixture
def cuda():
    """Skips where there is no card (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda", 0)
