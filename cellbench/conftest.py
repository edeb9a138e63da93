"""Tests of the benchmark's harness: ``src`` and the checkout's root on the
path, and the ``card`` marker for tests that need a CUDA device (they
decide inside a fixture whether one is present, and skip without it)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (run on the "
        "card with `python -m pytest -m card cellbench`)")
