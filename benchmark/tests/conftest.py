"""The benchmark's CPU tests: the repo root on the path, one torch thread
a worker."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True, scope='session')
def _threads():
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    yield
