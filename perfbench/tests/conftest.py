"""The benchmark's tests: CPU tests at small sizes, and tests marked ``gpu``
that skip themselves where PyTorch sees no card (run them on the card with
``python -m pytest -m gpu perfbench/tests -q``)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself elsewhere")
