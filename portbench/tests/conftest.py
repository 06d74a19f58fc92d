"""The harness's tests: at small sizes on the CPU, and (marked ``card``)
the benchmark's own command on a CUDA card.

    python -m pytest portbench/tests -q          # from the repository's root
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Small sizes of each cell for the CPU (the configuration's and traffic's
#: entries replaced).
SMALL = {
    "ares_ea.ppo_100k": {"traffic": {"num_envs": 96}},
    "ares_full.tune_100k": {"traffic": {"settings": 16, "reference_block": 8}},
    "ares_ea.screen_b1": {"config": {"particles": 20000}, "traffic": {"sample": 3,
                                                                     "warm_calls": 1}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skip the test where no CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def root():
    return ROOT
