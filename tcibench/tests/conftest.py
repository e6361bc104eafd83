"""The benchmark's tests import ``tcibench`` and ``tci_tpu_torch`` from the
checkout's root, and nothing of JAX."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny():
    from tiny import run_tiny
    return run_tiny
