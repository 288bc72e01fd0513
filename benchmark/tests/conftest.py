"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
checkout's root. Tests marked `cuda` need a card and skip without one (each
decides inside the test); on the card: `python -m pytest benchmark/tests -q -m cuda`."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
