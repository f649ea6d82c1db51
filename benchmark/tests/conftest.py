"""The benchmark's CPU tests: the harness and the reference at the
configurations' tiny sizes (each configuration's ``tiny`` key)."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
