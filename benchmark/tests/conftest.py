"""Test settings of the benchmark's own tests (`python -m pytest
benchmark/tests`): the checkout's root on the path, and the `card` marker
for tests that need a CUDA card (each decides for itself, inside the
test, and skips without one)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
