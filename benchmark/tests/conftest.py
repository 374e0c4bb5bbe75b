"""The benchmark's CPU tests: the benchmark's folder and the repository
root go on sys.path (as run.py puts them); the `card` fixture skips a
test when there is no CUDA card, decided when the test runs."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (HERE, os.path.join(BENCH, "metrics"), BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
