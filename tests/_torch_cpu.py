"""Shared by the tests/test_torch_*.py files: keep PyTorch to one CPU thread.

The plain versions work on tensors of a few hundred elements, where the
intra-op thread pool only costs synchronisation, and the test run uses
several worker processes at once; one thread per process is faster alone and
much faster side by side.  Import `one_torch_thread` into a test module to
apply it to every test there.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
