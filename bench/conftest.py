"""Pytest settings of the benchmark's own tests: the harness's folders
on the import path, the port under `src`, and the card marker."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (BENCH.parent / "src", BENCH):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "requires_cuda: needs an NVIDIA GPU with the CUDA toolkit "
        "(the port's hand-written kernels); skipped where there is none",
    )
