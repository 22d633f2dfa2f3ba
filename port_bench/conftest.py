"""pytest settings of the benchmark's own tests (port_bench/tests): the
marker of tests that need a CUDA card. Such a test decides inside itself
whether a card is present and skips on a machine without one; they run
on the card with ``python -m pytest port_bench/tests -q -m card``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
