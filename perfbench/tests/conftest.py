"""Settings of the benchmark's own tests.

`card` marks a test that needs a CUDA card; it skips elsewhere, decided
inside the `card` fixture when the test runs, never at import. Run them
on the card with:

    python3 -m pytest perfbench/tests -m card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test measures on the card")
    return "cuda"
