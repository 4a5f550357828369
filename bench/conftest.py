"""pytest settings of the benchmark's own tests (``bench/tests``): the
``cuda`` marker, and the port's ``src`` on the path as ``bench/run.py``
puts it."""
import sys
import time
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA H100; skips elsewhere (on the "
        "card: python -m pytest -m cuda bench/tests)")


@pytest.fixture
def tick_clock(monkeypatch):
    """``time.perf_counter`` made to advance 10 ms a reading, so a tiny
    run's window holds the same number of ticks however loaded the CPU
    is."""
    now = [time.perf_counter()]

    def clock():
        now[0] += 0.01
        return now[0]
    monkeypatch.setattr(time, "perf_counter", clock)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the tiny runs: the test workers share the
    CPU, and tiny products gain nothing from more."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
