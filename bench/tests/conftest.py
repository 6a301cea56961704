"""The benchmark's CPU tests run their small cells on one thread: a run's
window is measured in seconds, and on a host shared with other test
workers a thread pool per worker would spend them waiting for cores."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
