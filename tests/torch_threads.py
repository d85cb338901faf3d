"""One torch intra-op thread for a test module (`one_thread`, imported as
an autouse fixture): the port's CPU tests run small tensors, and the
driver's six test workers each opening a thread per core oversubscribe
the machine."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
