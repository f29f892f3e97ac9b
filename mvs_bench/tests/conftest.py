"""Settings of the benchmark's own tests (run with ``python -m pytest
mvs_bench/tests``; the repository's suite under ``tests/`` does not
collect them). Imports no JAX.

Tests that need a CUDA card carry the ``card`` marker and decide inside the
test whether one is there (``needs_card``), skipping on the CPU; on the
chip: ``python3 -m pytest mvs_bench/tests -m card -q``.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips on the CPU")


@pytest.fixture
def needs_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip")
