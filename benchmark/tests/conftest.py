"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
root of the checkout.  They run on the CPU; a test marked `card` needs the
H100 and skips elsewhere, deciding inside the test."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the CUDA card; skips without it")
