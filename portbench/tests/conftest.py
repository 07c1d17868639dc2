"""Self-tests of the benchmark: `python -m pytest portbench/tests -q` from
the root of the checkout. Tests marked `card` need an NVIDIA card and skip
without one; on the card: `python -m pytest portbench/tests -q -m card`."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch thread a test process: with several pytest workers, more
    threads spin against each other in every matrix product."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)
