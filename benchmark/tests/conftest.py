"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
checkout's root (the repository's ``pytest tests/`` does not collect them).
Tests marked ``chip`` need a CUDA card and skip without one, deciding
inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")
