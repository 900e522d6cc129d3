"""PyTorch's intra-op threads for the ``test_torch_port_*`` tests, without
JAX (``tests/test_torch_port_cuda.py`` imports it on a machine that has only
PyTorch)."""

import contextlib
import os

import pytest


@contextlib.contextmanager
def torch_threads(n):
    """PyTorch's intra-op threads set to ``n`` for the duration (the tests
    run in several worker processes at once: eight threads each
    oversubscribe the cores)."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def capped_torch_threads():
    """PyTorch's intra-op threads capped for a test module: 2 under xdist
    (six workers of eight threads each thrash the cores), 4 otherwise. A
    test module takes it with ``from tests.torch_port_threads import
    capped_torch_threads  # noqa: F401``."""
    with torch_threads(2 if os.environ.get("PYTEST_XDIST_WORKER") else 4):
        yield
