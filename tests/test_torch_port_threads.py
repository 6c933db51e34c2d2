"""One PyTorch CPU thread for each of the port's test files.

The suite runs in several worker processes at once, and PyTorch starts one
intra-op thread per core in each of them: six workers on eight cores then
run some fifty spinning threads, and the port's CPU tests (the plain
versions of the kernels, small models) spend most of their time waiting
for a core. Each port test file imports this fixture::

    from test_torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

It holds PyTorch to one thread while the file's tests run and restores the
count afterwards, so the JAX package's tests in the same worker keep it.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_tests_run_on_one_torch_thread():
    """The fixture is autouse here too: this file's tests see one thread."""
    assert torch.get_num_threads() == 1
