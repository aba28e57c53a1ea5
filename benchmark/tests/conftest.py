"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

They run on the CPU at tiny sizes through the program's plain routes; a
test that needs the card is marked ``cuda`` and decides inside itself
whether one is there."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
