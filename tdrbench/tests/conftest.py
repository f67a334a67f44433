"""Settings for the benchmark's own tests (``pytest tdrbench/tests``).

The ``card`` marker flags a test that needs a CUDA device; such a test
skips, from inside itself, where there is none."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")
